"""The program's own spans and counters in a traced window.

``limg_tpu_torch`` marks each stage of an encode with a ``record_function``
span named ``limg.*`` (``utils/diagnostics.span``: the entry spans
``limg.encode_image_merged`` and ``limg.encode_image_device``, and inside
them one span a stage) and counts each coalesce buffer of the segment
encode, ``limg.segments.members.p<P>`` (lanes holding a run member) and
``limg.segments.lanes.p<P>`` (its lanes), collected per image by its
``diagnostics.record_counts()``. The spans are host events of the same
Chrome trace as the device operations (``trace.py``), on one clock, so this
module reduces them over the same window, the same device operations and
the same idle gaps as ``trace.reduce_trace``:

- ``reduce_spans``: per traced image the host enqueue time of its entry
  span, and per span name a stage row: the device time and the launches of
  the operations launched with that span innermost, its host self time,
  the device idle time whose gap midpoint it covers, and the blocking
  runtime calls made inside it; ``OUTSIDE`` is what no span covers;
- ``segment_lane_use`` and ``segment_roofline``: readings of the counters.

The parent of a traced window may be a program without spans or counters:
then the rows hold ``OUTSIDE`` alone and the readings are None.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import trace as tracing

PROGRAM_PREFIX = "limg."
ENTRY_SPANS = ("limg.encode_image_merged", "limg.encode_image_device")
OUTSIDE = "(outside the program)"
MEMBERS, LANES = "limg.segments.members.p", "limg.segments.lanes.p"
ROW_KEYS = ("device_ms", "host_self_ms", "idle_ms", "launches", "syncs")


@dataclass
class Spans:
    """The program's spans in the traced window. ``enqueue_s``: per traced
    image with an entry span, that span's duration less the blocking runtime
    calls inside it on its thread (s); ``rows``: span name -> ``ROW_KEYS``
    summed over the window (times in ms)."""

    images: int = 0
    enqueue_s: list = field(default_factory=list)
    rows: dict = field(default_factory=dict)

    def stages(self) -> list:
        """The stage breakdown, per image: [name, {device_ms, host_self_ms,
        idle_ms, launches, syncs}], the most device time first."""
        n = max(self.images, 1)
        out = [[name, {k: v / n for k, v in row.items()}] for name, row in self.rows.items()]
        return sorted(out, key=lambda r: (-r[1]["device_ms"], r[0]))


def _row(rows: dict, name: str) -> dict:
    return rows.setdefault(name, dict.fromkeys(ROW_KEYS, 0.0))


def _self_times(spans: list) -> tuple:
    """(id(span) -> its duration less its direct child spans, the summed
    duration of the outermost spans): the program's spans nest on their
    thread."""
    self_s, open_, top = {}, {}, 0.0
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        stack = open_.setdefault(e.get("tid"), [])
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"] + e["dur"]:
            stack.pop()
        self_s[id(e)] = e["dur"]
        if stack:
            self_s[id(stack[-1])] -= e["dur"]
        else:
            top += e["dur"]
        stack.append(e)
    return self_s, top


def reduce_spans(events: list) -> Spans:
    """``Spans`` of the Chrome trace ``events`` between the first image
    span's start and the last one's end (``trace.reduce_trace``'s window)."""
    images = [e for e in tracing._complete(events, ("user_annotation", "cpu_op"))
              if e["name"] == tracing.IMAGE_SPAN]
    if not images:
        return Spans()
    t0 = min(e["ts"] for e in images)
    t1 = max(e["ts"] + e["dur"] for e in images)
    inside = [e for e in events if e.get("ph") == "X" and "ts" in e
              and e["ts"] >= t0 and e["ts"] + e.get("dur", 0) <= t1 + 1.0]
    dev = tracing._complete(inside, tracing.DEVICE_CATS)
    runtime = tracing._complete(inside, ("cuda_runtime", "cuda_driver"))
    prog = [e for e in tracing._complete(inside, ("user_annotation", "cpu_op"))
            if e["name"].startswith(PROGRAM_PREFIX)]
    index = tracing._HostIndex(prog)
    sp = Spans(images=len(images))
    rows: dict = {}
    _row(rows, OUTSIDE)

    def stage(t: float, tid=None) -> str:
        e = index.innermost(t, tid)
        return e["name"] if e else OUTSIDE

    # device time and launches by the innermost span around the launch call
    launched = {r["args"]["correlation"]: stage(r["ts"], r.get("tid")) for r in runtime
                if r.get("args", {}).get("correlation") is not None}
    for e in dev:
        row = _row(rows, launched.get(e.get("args", {}).get("correlation"), OUTSIDE))
        row["device_ms"] += e.get("dur", 0) / 1e3
        row["launches"] += 1
    blocking = [r for r in runtime if r["name"] in tracing.BLOCKING_CALLS]
    for r in blocking:
        _row(rows, stage(r["ts"], r.get("tid")))["syncs"] += 1
    # host self time: each span less its children; outside, the window less
    # the outermost spans
    self_s, top = _self_times(prog)
    for e in prog:
        _row(rows, e["name"])["host_self_ms"] += self_s[id(e)] / 1e3
    rows[OUTSIDE]["host_self_ms"] += (t1 - t0 - top) / 1e3
    # idle gaps, each put to the span around its middle (trace.reduce_trace's gaps)
    busy = tracing._union([(max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)) for e in dev])
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            _row(rows, stage((s + e) / 2))["idle_ms"] += (e - s) / 1e3
    sp.rows = rows
    # host enqueue: each image's entry span less the blocking calls inside it
    for img in sorted(images, key=lambda e: e["ts"]):
        entry = [e for e in prog if e["name"] in ENTRY_SPANS and img["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= img["ts"] + img["dur"]]
        if not entry:
            continue
        e = max(entry, key=lambda e: e["dur"])
        waits = sum(r["dur"] for r in blocking if r.get("tid") == e.get("tid")
                    and e["ts"] <= r["ts"] and r["ts"] + r["dur"] <= e["ts"] + e["dur"])
        sp.enqueue_s.append((e["dur"] - waits) / 1e6)
    return sp


def host_enqueue_ms(spans: Spans) -> float | None:
    """The mean host enqueue time of the traced images, in ms."""
    if not spans.enqueue_s:
        return None
    return sum(spans.enqueue_s) / len(spans.enqueue_s) * 1e3


def _buffers(counts: list) -> dict:
    """P -> (members, lanes) summed over the traced images' counts ({name:
    [values]} an image)."""
    out: dict = {}
    for image in counts or ():
        for name, vals in image.items():
            for prefix, k in ((MEMBERS, 0), (LANES, 1)):
                if name.startswith(prefix):
                    tot = out.setdefault(int(name[len(prefix):]), [0, 0])
                    tot[k] += sum(vals)
    return out


def segment_lane_use(counts: list) -> float | None:
    """Lanes holding a run member over every coalesce buffer's lanes, in %."""
    tot = _buffers(counts).values()
    lanes = sum(t[1] for t in tot)
    return 100.0 * sum(t[0] for t in tot) / lanes if lanes else None


def segment_roofline(counts: list, port_s: dict, cfg) -> float | None:
    """The segment encode's bound (``counts.segment_encode.lane_bound`` of
    each buffer's members and lanes) over its device time (the
    ``segment_encode_p<P>`` labels), over every P with both, in %."""
    from ..counts.segment_encode import lane_bound

    bound = time = 0.0
    for p, (members, lanes) in _buffers(counts).items():
        t = port_s.get(f"segment_encode_p{p}", 0.0)
        if t > 0:
            bound += lane_bound(members, lanes, p, cfg.channels, cfg)[0]
            time += t
    return 100.0 * bound / time if time else None
