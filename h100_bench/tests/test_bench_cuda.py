"""The benchmark on the card: each cell run as `run.py` runs it, with a short window.

    python -m pytest h100_bench/tests/test_bench_cuda.py -m cuda -q

Skips where torch sees no card.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell: str, seed: int, trace: int) -> dict:
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
                        str(seed), "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    last = _run(cell, 2**31 + 4242, 0)
    assert last["correct"] is True and last["failed"] == 0
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
    assert {"encode_mpx_s", "setup_s"} <= set(last["metrics"])
    traced = _run(cell, 2**31 + 4243, 1)
    assert traced["correct"] is True and 0 < traced["device"]["busy_s"]
    listed = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(traced["metrics"]) == listed
