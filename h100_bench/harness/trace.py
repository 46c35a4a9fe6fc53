"""Read a ``torch.profiler`` trace of part of the window.

The harness profiles a steady stretch of the window with CPU and CUDA
activities, each image inside a ``record_function`` span (``IMAGE_SPAN``),
exports the Chrome trace and reduces it here to a ``Trace``: the device
operations (kernels, copies, fills) inside the traced window, which of them
are the port's own kernels (a ``__global__`` function of the port's
``csrc/``), the runtime calls that block the host, and each card's idle
gaps with what the host was doing in each.

A cell on several cards is read card by card: a device operation belongs
to the card its event names (``args.device``, else its ``pid``), busy
intervals are merged within a card only, and the busy time is the mean of
the cards'. Operation counts and device times are sums over every card.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

IMAGE_SPAN = "h100_bench.image"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# runtime calls after which the host waits for the device
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy", "cudaMemcpy2D", "cudaMemset")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
# a kernel's symbol as the profiler names it: the port's kernels live in an
# anonymous namespace ("void (anonymous namespace)::encode_region_kernel<64,
# 3>(...)"); PyTorch's in named ones (at::native::...)
_KERNEL = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)(?:<([^>]*)>)?\s*\(")


def port_kernel_names(csrc: Path) -> frozenset:
    """The ``__global__`` function names of the port's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def kernel_label(symbol: str, port_names: frozenset) -> str | None:
    """The name a port kernel's launch count has (``encode_fixed_p64``,
    ``segment_encode_p256``, ``fit_levels`` ...) for a profiled symbol of a
    port kernel; None for any other kernel."""
    m = _KERNEL.match(symbol)
    if not m or m.group(1) not in port_names:
        return None
    fn, targs = m.group(1), [t.strip() for t in (m.group(2) or "").split(",") if t.strip()]
    name = fn[:-len("_kernel")] if fn.endswith("_kernel") else fn
    if name in ("fit_levels", "owner_crush"):
        return name + ("_natural" if targs[-1:] == ["true"] else "")
    if name == "encode_region" and targs:     # one template; P = 64 is the fixed grid's
        return "encode_fixed_p64" if targs[0] == "64" else f"encode_region_p{targs[0]}"
    if name in ("segment_encode", "segment_cluster", "segment_prep") and len(targs) > 1:
        # <CH, log2 of P / 64>: P = 64 and 256 one warp a region, P >= 1024
        # the cluster design's two kernels
        return f"segment_encode_p{64 << int(targs[1])}"
    return {"seg_scan": "seg_mixed_all", "crush_eval": "crush_eval_rows"}.get(name, name)


@dataclass
class Trace:
    """The traced window, reduced. Times in seconds."""

    images: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0                             # the mean of busy_s_per_card
    busy_s_per_card: tuple = ()                     # union of a card's busy intervals
    launches: int = 0                               # over every card
    host_syncs: int = 0
    port_s: dict = field(default_factory=dict)      # port kernel label -> device s, all cards
    glue_s: dict = field(default_factory=dict)      # other device op -> device s, all cards
    idle_by_host: dict = field(default_factory=dict)  # host activity -> idle card s, summed
    traced_indices: tuple = ()                      # the window's call indices traced

    def device_ops(self, top: int = 10) -> list:
        ops = [*self.port_s.items(), *self.glue_s.items()]
        return [[k, v] for k, v in sorted(ops, key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]]


def _complete(events: list, cats) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _HostIndex:
    """The innermost host event covering an instant, per thread."""

    def __init__(self, events: list):
        self.events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.events]

    def innermost(self, t: float, tid=None):
        i = bisect.bisect_right(self.starts, t)
        best = None
        # walk back over the events that start before t; the latest-starting
        # one still open at t is the innermost
        for j in range(i - 1, max(-1, i - 4096), -1):
            e = self.events[j]
            if (tid is None or e.get("tid") == tid) and e["ts"] + e["dur"] >= t:
                best = e
                break
        return best


def _card(event) -> int:
    """The index of the card a device event ran on: ``args.device``, else
    ``pid`` (the card where the profiler exports no ``args.device``)."""
    return int(event.get("args", {}).get("device", event.get("pid", 0)))


def reduce_trace(events: list, port_names: frozenset, traced_indices: tuple = (),
                 cards: int = 1) -> Trace:
    """A ``Trace`` of the Chrome trace ``events`` between the first image
    span's start and the last one's end, on the cell's cards ``0`` ...
    ``cards - 1``, in that order: a card with no operation reads idle. A
    device operation on any other card is refused (``ValueError``): the
    program ran outside the cards it was given."""
    spans = [e for e in _complete(events, ("user_annotation", "cpu_op"))
             if e["name"] == IMAGE_SPAN]
    if not spans:
        return Trace(traced_indices=traced_indices)
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    inside = [e for e in events if e.get("ph") == "X" and "ts" in e
              and e["ts"] >= t0 and e["ts"] + e.get("dur", 0) <= t1 + 1.0]
    dev = _complete(inside, DEVICE_CATS)
    host = [e for e in _complete(inside, HOST_CATS) if e["name"] != IMAGE_SPAN]
    runtime = [e for e in host if e["cat"] in ("cuda_runtime", "cuda_driver")]
    ops = _HostIndex([e for e in host if e["cat"] in ("cpu_op", "user_annotation")])
    # the PyTorch operation that launched each device op, by correlation id
    launcher = {}
    for r in runtime:
        corr = r.get("args", {}).get("correlation")
        if corr is not None:
            op = ops.innermost(r["ts"], r.get("tid"))
            launcher[corr] = op["name"] if op else r["name"]
    tr = Trace(images=len(spans), window_s=(t1 - t0) / 1e6, launches=len(dev),
               traced_indices=traced_indices)
    tr.host_syncs = sum(1 for r in runtime if r["name"] in BLOCKING_CALLS)
    for e in dev:
        s = e.get("dur", 0) / 1e6
        label = kernel_label(e["name"], port_names) if e["cat"] == "kernel" else None
        if label:
            tr.port_s[label] = tr.port_s.get(label, 0.0) + s
        else:
            by = launcher.get(e.get("args", {}).get("correlation"))
            key = f"{by}: {e['name'][:60]}" if by else e["name"][:80]
            tr.glue_s[key] = tr.glue_s.get(key, 0.0) + s
    busy_cards = [[] for _ in range(cards)]
    for e in dev:
        c = _card(e)
        if not 0 <= c < cards:
            raise ValueError(f"a device operation ({e['name'][:60]}) on card {c}, "
                             f"outside the cell's {cards}")
        busy_cards[c].append(e)
    every = _HostIndex(host)
    per_card = []
    for card_ops in busy_cards:
        busy = _union([(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1))
                       for e in card_ops])
        per_card.append(sum(e - s for s, e in busy if e > s) / 1e6)
        # the card's idle gaps, each put to the host activity at its middle
        edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            ev = every.innermost((s + e) / 2)
            key = ev["name"] if ev else "host (no traced call)"
            tr.idle_by_host[key] = tr.idle_by_host.get(key, 0.0) + (e - s) / 1e6
    tr.busy_s_per_card = tuple(per_card)
    tr.busy_s = sum(per_card) / len(per_card)
    return tr


def read_chrome_trace(path: Path) -> list:
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data
