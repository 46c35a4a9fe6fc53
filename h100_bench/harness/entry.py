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

``image`` is one item of the traffic's pool, what one call encodes: an
(H, W, C) image, or a (B, H, W, C) batch of frames in a batched cell, whose
counts then cover the whole batch. ``device`` is the card of a one-card
cell (``cuda:0``), or the tuple of the cards of a cell of several,
``cuda:0`` ... ``cuda:{chips - 1}`` (``main.call_device``), so a call
across cards learns them from the harness, never by counting the visible
cards.
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
