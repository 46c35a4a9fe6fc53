"""The program's spans and counters on the card.

    python -m pytest h100_bench/tests/test_bench_spans_cuda.py -m cuda -q

In a profiled default merged encode of a 4K photo every port kernel is
launched inside the stage span it belongs to, and starts on the device
after its launch call (spans and device operations share one clock, up to
the profiler's mapping of device time onto the host's). A
recording of the counters adds no launch and no host sync to any of the
three cells' paths: the device operations and blocking runtime calls of
a profiled image (``trace.reduce_trace``, as the harness counts them),
and the syncs ``torch.cuda.set_sync_debug_mode("warn")`` reports by the
line that made them, are the same with a recording open and without.
Skips where torch sees no card.
"""

import contextlib
import os
import tempfile
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

import limg_tpu_torch
from h100_bench.harness import spec
from h100_bench.harness import trace as tracing
from limg_tpu_torch.utils import diagnostics

pytestmark = pytest.mark.cuda

# how far the trace may put a kernel's start before its launch call: the
# profiler maps the device's timestamps onto the host's clock, and one run
# in three put a kernel 116 us early
CLOCK_SLACK_US = 500.0

# the stage span each port kernel of the default merged path is launched in
KERNEL_STAGES = {
    "fit_levels": {"limg.pre.fit"},
    "owner_crush": {"limg.pre.crush"},
    "match_neighbors": {"limg.pre.runs"},
    "match_pairs": {"limg.pre.runs"},
    "seg_mixed_all": {"limg.pre.runs", "limg.finish.coalesce"},
    "segment_encode_p64": {"limg.finish.coalesce"},
}


def _photo(card, seed: int = 2**31 + 77):
    cell = spec.load_cell("merged-photo-45mp")
    gen = spec.load_module("traffic", cell.traffic["generator"])
    return gen.make_pool(dict(cell.traffic, height=2160, width=3840, pool=1), seed, card)[0]


def _encode(path: str, image, card):
    cfg = limg_tpu_torch.EncodeConfig()
    if path == "fixed":
        return lambda: limg_tpu_torch.encode_image_device(image, cfg, 5, device=card)
    levels = 5 if path == "dense" else 3
    return lambda: limg_tpu_torch.encode_image_merged(image, cfg, 5, num_levels=levels,
                                                      fetch_planes=False, fetch_decoded=False,
                                                      device=card)


def _profiled(fn) -> list:
    """The complete events of a profiled call of ``fn`` in an image span
    that ends when the device has finished it, after one call under the
    profiler outside the span: the profiler can miss device activity just
    after it starts (the harness, too, traces a stretch that begins
    seconds into its window)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with torch.profiler.record_function(tracing.IMAGE_SPAN):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return [e for e in tracing.read_chrome_trace(Path(path)) if e.get("ph") == "X"]
    finally:
        os.remove(path)


def test_port_kernels_launch_inside_their_stage_spans(card):
    enc = _encode("merged", _photo(card), card)
    enc()
    events = _profiled(enc)
    port = tracing.port_kernel_names(Path(limg_tpu_torch.__file__).parent / "csrc")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    index = tracing._HostIndex([e for e in events if e.get("cat") == "user_annotation"
                                and e["name"].startswith("limg.")])
    t0, = [e["ts"] for e in events
           if e["name"] == tracing.IMAGE_SPAN and e.get("cat") == "user_annotation"]
    seen: dict = {}
    for e in events:
        label = tracing.kernel_label(e["name"], port) if e.get("cat") == "kernel" else None
        if label is None:
            continue
        launch = launches[e["args"]["correlation"]]
        if launch["ts"] < t0:
            continue
        span = index.innermost(launch["ts"], launch.get("tid"))
        seen.setdefault(label, set()).add(span["name"] if span else None)
        assert e["ts"] >= launch["ts"] - CLOCK_SLACK_US, (label, e["ts"], launch["ts"])
    assert {"fit_levels", "owner_crush", "segment_encode_p64"} <= set(seen) <= set(KERNEL_STAGES)
    for label, spans in seen.items():
        assert spans <= KERNEL_STAGES[label], (label, spans)


def _sync_warnings(fn) -> Counter:
    """The syncs ``fn`` makes, by the line of Python that made each."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                   if "synchroniz" in str(w.message))


@pytest.mark.parametrize("path", ["merged", "dense", "fixed"])
def test_a_recording_adds_no_launch_and_no_sync(card, path):
    enc = _encode(path, _photo(card), card)
    enc()
    _sync_warnings(enc)
    port = tracing.port_kernel_names(Path(limg_tpu_torch.__file__).parent / "csrc")
    seen = {}
    for record in (False, True):
        with diagnostics.record_counts() if record else contextlib.nullcontext() as rec:
            tr = tracing.reduce_trace(_profiled(enc), port)
            syncs = _sync_warnings(enc)
        seen[record] = (tr.launches, tr.host_syncs, sorted(syncs.items()))
    assert seen[True] == seen[False]
    assert seen[True][0] > 0
    counts = rec.drain()
    levels = {"merged": 1, "dense": 5, "fixed": 0}[path]
    assert len(counts) == 2 * levels and all(len(v) == 3 for v in counts.values())
