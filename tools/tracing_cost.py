"""Host cost of the port's spans and counters (``limg_tpu_torch/utils/diagnostics``).

    python3 tools/tracing_cost.py [--calls 100000]

Times, in us a call on this host: ``with span(name)`` and ``count(name,
value)`` (a host int, a 0-d device tensor) with nothing listening, inside
an open ``record_counts()``, and under ``torch.profiler`` (CPU, and CUDA
where there is a card); ``record_function`` with the profiler off, for
comparison; and one ``drain`` of ten device values (a stack and one copy).
Prints one JSON line with the device's name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def per_call_us(fn, calls: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=100000)
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from limg_tpu_torch.utils.diagnostics import count, record_counts, span

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    value = torch.zeros((), dtype=torch.int64, device=dev)

    def in_span():
        with span("limg.cost"):
            pass

    def rf():
        with torch.profiler.record_function("limg.cost"):
            pass

    n = args.calls
    out = dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               calls=n,
               span_off=per_call_us(in_span, n),
               count_off=per_call_us(lambda: count("limg.cost", 1), n),
               record_function_off=per_call_us(rf, n))
    with record_counts():
        out["count_recording_int"] = per_call_us(lambda: count("limg.cost", 1), n)
        out["count_recording_tensor"] = per_call_us(lambda: count("limg.cost", value), n)
        out["span_recording"] = per_call_us(in_span, n)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts):
        out["span_profiled"] = per_call_us(in_span, n // 10)
        out["count_profiled"] = per_call_us(lambda: count("limg.cost", 1), n // 10)
    drains = []
    for _ in range(20):
        with record_counts() as rec:
            for i in range(10):
                count(f"limg.cost{i}", value)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.drain()
        drains.append((time.perf_counter() - t0) * 1e6)
    out["drain_10_values"] = sorted(drains)[len(drains) // 2]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
