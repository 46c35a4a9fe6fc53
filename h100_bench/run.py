"""Run one cell of the benchmark of limg_tpu_torch on the card(s) of this machine.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``limg_tpu_torch`` package. Prints one JSON line last on standard
output (see ``harness/main.py``); exits non-zero, with no result, where
there is no card, fewer cards than the cell asks for, no package to
measure, or JAX or the JAX package in the process.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from h100_bench.harness.main import main

    sys.exit(main(sys.argv[1:], started=STARTED))
