"""A cell's traced images broken down by the program's own spans and counters.

    python3 h100_bench/stages.py --workload <cell> --seed <n> [--images 6] \\
        [--warm-seconds 2] [--out stages.jsonl]

Set-up as ``run.py`` makes it (the pool from the seed, each image once
through the cell's entry), then ``--warm-seconds`` of untraced images and
``--images`` images under ``torch.profiler``, each in the harness's image
span and inside the program's ``utils/diagnostics.record_counts()``; the
counts are read after the profiler stops. Prints one JSON line: the traced
wall per image, the cell's per-layer metrics as ``run.py --trace 1`` reads
them (``metrics/``), the readings of ``harness/spans.py``
(``host_enqueue_ms_per_image``, ``segment_lane_use``,
``segment_roofline``) and the breakdown: ``device_ops``, ``idle_gaps`` and
``stages``, one row per program span. Runs on a program without spans or
counters as well (the readings are then null). ``--out`` also appends the
line to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traced_images(call, pool: list, seed: int, images: int, warm_s: float, record,
                  devices: tuple):
    """Untraced images for ``warm_s``, then ``images`` profiled ones, each
    in ``IMAGE_SPAN`` and ``record()``. Returns (Chrome trace events, the
    traced indices, each traced image's counts or None, traced wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from h100_bench.harness import main as harness
    from h100_bench.harness import trace as tracing

    k, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        call(pool[k % len(pool)], seed + k)
        k += 1
    harness.synchronize(devices)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    recs, traced = [], []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(k, k + images):
            with torch.profiler.record_function(tracing.IMAGE_SPAN), record() as rec:
                call(pool[k % len(pool)], seed + k)
            recs.append(rec)
            traced.append(k)
        harness.synchronize(devices)
        wall = time.perf_counter() - t0
    counts = [rec.drain() if rec is not None else None for rec in recs]
    fd, path = tempfile.mkstemp(prefix="h100_bench_stages_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tracing.read_chrome_trace(Path(path))
    finally:
        os.remove(path)
    return events, tuple(traced), counts, wall


def stage_run(cell, seed: int, images: int, warm_s: float, devices: tuple, program) -> dict:
    """The line of one cell (``cell`` a ``spec.Cell``, on its cards
    ``devices``) on ``program``."""
    from h100_bench import reference as ref
    from h100_bench.harness import entry as entries
    from h100_bench.harness import main as harness
    from h100_bench.harness import spans as program_spans
    from h100_bench.harness import spec
    from h100_bench.harness import trace as tracing

    entry = entries.load(cell.config)
    gen = spec.load_module("traffic", cell.traffic["generator"])
    params = dict(cell.config.get("call", {}))
    cfg = entries.encode_config(program, cell.config)
    device = harness.call_device(devices)
    pool = gen.make_pool(cell.traffic, seed, device)

    def call(image, s):
        return entry.call(program, image, cfg, s, params, device)

    for i, image in enumerate(pool):
        call(image, seed + harness.WARM_SEED_OFFSET + i)
    try:   # a program without counters (the parent of the change that added them)
        record = importlib.import_module(f"{program.__name__}.utils.diagnostics").record_counts
    except (ImportError, AttributeError):
        record = contextlib.nullcontext
    events, traced, counts, wall = traced_images(call, pool, seed, images, warm_s, record,
                                                 devices)
    port = Path(program.__file__).parent / "csrc"
    tr = tracing.reduce_trace(events, tracing.port_kernel_names(port), traced, len(devices))
    sp = program_spans.reduce_spans(events)
    if any(c is None for c in counts):
        counts = None

    # the per-layer metrics as the harness reads them
    run = harness.Run(setup_s=0.0, latencies_s=[], window_s=wall, pixels=0, trace=tr)
    cfg_r = entries.encode_config(ref, cell.config)
    run.bound_jobs = harness.count_jobs(entry, ref, pool, cfg_r, seed, params, device)
    metrics = {}
    for m in cell.metrics(True):
        value = spec.load_module("metrics", m.name).read(run)
        if value is not None:
            metrics[m.name] = float(value)
    return dict(
        workload=cell.name, seed=seed, images=len(traced),
        traced_ms_per_image=wall / len(traced) * 1e3,
        metrics=metrics,
        host_enqueue_ms_per_image=program_spans.host_enqueue_ms(sp),
        segment_lane_use=program_spans.segment_lane_use(counts),
        segment_roofline=program_spans.segment_roofline(counts, tr.port_s, cfg_r),
        counts=counts,
        breakdown=dict(device_ops=tr.device_ops(), idle_gaps=tr.idle_gaps(),
                       stages=sp.stages()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--images", type=int, default=6)
    p.add_argument("--warm-seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from h100_bench.harness import main as harness
    from h100_bench.harness import spec

    harness.set_cache_dirs(spec.ROOT)
    cell = spec.load_cell(args.workload)
    devices = harness.cell_devices(cell.chips)
    program = harness.import_program(spec.ROOT)
    line = stage_run(cell, args.seed, args.images, args.warm_seconds, devices, program)
    line["card"] = torch.cuda.get_device_name(devices[0])
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
