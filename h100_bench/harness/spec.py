"""Find a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names the cell's
configuration and traffic and lists the metrics; each of those names is a
file of this folder:

    configs/<config>.json      the configuration (entry point, its settings)
    traffic/<traffic>.json     the traffic's parameters; its "generator"
                               names traffic/<generator>.py
    workloads/<cell>.json      the cell's own settings and check limits
    entries/<entry>.py         calls one public entry point of the port
                               (``harness/entry.py``)
    metrics/<metric>.py        reads one metric of a finished run
    counts/<kernel>.py         the work of one kernel (or
                               counts/<family>.py for <family>_p<P>)

A traffic generator has ``make_pool(params, seed, device)``: the list of
items the window's calls encode in turn, each an (H, W, C) image or a
(B, H, W, C) batch of B frames, on a card or in host memory. One call of
an item encodes B x H x W pixels (H x W for an image), and B scales the
item's ``counts.common.Job``.

The cell's cards are ``cuda:0`` ... ``cuda:{chips - 1}``; the harness hands
them over, and no module looks for cards itself. A traffic generator or an
entry receives as its ``device`` the card of a one-card cell, or the tuple
of the cards of a cell of several (``harness.main.call_device``).

A later cell, configuration, traffic or metric is added by adding files.
"""

from __future__ import annotations

import importlib
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
PACKAGE = BENCH_DIR.name

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A cell, file or metric that cannot be found or read."""


def _checked(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise SpecError(f"not a name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` of this folder."""
    path = BENCH_DIR / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise SpecError(f"no {kind} file {PACKAGE}/{kind}/{name}.json")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this folder (a name's dots and dashes
    become underscores in the file name)."""
    stem = _checked(name).replace(".", "_").replace("-", "_")
    if not (BENCH_DIR / kind / f"{stem}.py").is_file():
        raise SpecError(f"no {kind} module {PACKAGE}/{kind}/{stem}.py")
    return importlib.import_module(f"{PACKAGE}.{kind}.{stem}")


def count_module(kernel: str):
    """``counts/<kernel>.py``, else ``counts/<family>.py`` for a kernel named
    ``<family>_p<P>``; None if neither exists."""
    for stem in (kernel, re.sub(r"_p\d+$", "", kernel)):
        if (BENCH_DIR / "counts" / f"{stem}.py").is_file():
            return importlib.import_module(f"{PACKAGE}.counts.{stem}")
    return None


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    settings: dict
    end_to_end: tuple
    per_layer: tuple

    def metrics(self, traced: bool) -> tuple:
        return self.per_layer if traced else self.end_to_end


def _metrics_of(entries: list, cell: str) -> tuple:
    return tuple(Metric(m["name"], m["unit"], m["better"], m["source"]) for m in entries
                 if "workloads" not in m or cell in m["workloads"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench_file = root / "BENCHMARK.json"
    if not bench_file.is_file():
        raise SpecError(f"no {bench_file.name} at {root}")
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], config=load_json("configs", w["config"]),
        traffic_name=w["traffic"], traffic=load_json("traffic", w["traffic"]),
        settings=load_json("workloads", name),
        end_to_end=_metrics_of(bench["end_to_end"], name),
        per_layer=_metrics_of(bench["per_layer"], name))
