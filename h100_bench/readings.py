"""The two readings each check limit is set from, in one process on the card.

    python3 h100_bench/readings.py --workload <cell> --seeds 11 12 ... \\
        --control-seeds 21 22 23 --seconds 3 [--out readings.jsonl]

For each of ``--seeds`` a run of the cell as the benchmark makes it (its
pool from the seed, a window of ``--seconds``, the check on the sampled
images) with the port as the program: the largest number any of them gives
is the lower reading. For each of ``--control-seeds`` the same run with the
control (``control.py``: the reference in bfloat16 sums) as the program:
the smallest number any of them gives is the upper reading. Prints one JSON
line a run and a summary line last; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from h100_bench import control
    from h100_bench.harness import main as harness
    from h100_bench.harness import spec

    harness.set_cache_dirs(spec.ROOT)
    cell = spec.load_cell(args.workload)
    devices = harness.cell_devices(cell.chips)
    program = harness.import_program(spec.ROOT)
    lines, lower, upper = [], {}, {}
    runs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for kind, seed in runs:
        run_args = argparse.Namespace(workload=cell.name, seed=seed, seconds=args.seconds, trace=0)
        t0 = time.perf_counter()
        result, _ = harness.run_cell(run_args, time.perf_counter(), cell=cell, devices=devices,
                                     program=program if kind == "program" else control)
        numbers = {k: v["value"] for k, v in result["check"].items()}
        line = dict(kind=kind, seed=seed, correct=result["correct"], images=result["attempted"],
                    seconds=time.perf_counter() - t0, numbers=numbers,
                    memory_peak_bytes=result["device"]["memory_peak_bytes"])
        lines.append(line)
        print(json.dumps(line), flush=True)
        into, pick = (lower, max) if kind == "program" else (upper, min)
        for k, v in numbers.items():
            v = float(v)
            into[k] = v if k not in into else pick(into[k], v)
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    summary = dict(summary=True, workload=cell.name, lower=lower, upper=upper,
                   card=torch.cuda.get_device_name(devices[0]))
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
