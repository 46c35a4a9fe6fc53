"""What an entry module (``entries/<entry>.py``) gives and takes.

An entry module has three functions:

    call(lib, image, cfg, seed, params, device) -> Output
        one encode through ``lib`` (the port, or the reference: the same
        public names), the totals a user reads on the host;
    compare(got, want, image) -> {number: value}
        the gaps of the port's output from the reference's, each number
        held to a limit of the cell's (``workloads/<cell>.json``);
    run_members(lib, image, cfg, seed, params, device) -> {kernel: counts}
        work counts that depend on the image's content, for
        ``counts/<kernel>.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from . import spec


class Output(NamedTuple):
    totals: dict      # what the user reads, on the host
    kept: Any         # device outputs the check compares, or None


def load(config: dict):
    """The entry module the configuration names."""
    return spec.load_module("entries", config["entry"])


def encode_config(lib, config: dict):
    """``lib.EncodeConfig`` with the configuration's settings."""
    return lib.EncodeConfig(**config.get("encode_config", {}))
