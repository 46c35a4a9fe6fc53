"""The benchmark on the card: each cell run as `run.py` runs it, with a short window.

    python -m pytest h100_bench/tests/test_bench_cuda.py -m cuda -q

Skips where torch sees no card; the batch cell on two cards skips where torch
sees fewer.
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


def test_a_batch_cell_on_two_cards(two_cards, batch_cell):
    """The batch cell (``tests/batch_cell/``) on ``cuda:0`` and ``cuda:1``:
    every card has its peak and its busy time, and the idle share is the
    cards' mean."""
    untraced, traced = batch_cell("cuda", 2**31 + 4244, 3.0)
    print(json.dumps(untraced))
    print(json.dumps(traced))
    for result in (untraced, traced):
        assert result["correct"] is True and result["failed"] == 0, result["check"]
        dev = result["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 2
        peaks = dev["memory_peak_bytes_per_card"]
        assert len(peaks) == 2 and min(peaks) > 0 and dev["memory_peak_bytes"] == max(peaks)
    assert untraced["metrics"]["call_pixels_stub"]["value"] == 4 * 24 * 40
    dev, m = traced["device"], traced["metrics"]
    busy = dev["busy_s_per_card"]
    assert len(busy) == 2 and min(busy) > 0
    assert dev["busy_s"] == pytest.approx(sum(busy) / 2, rel=1e-12)
    assert m["device_idle_share"]["value"] == pytest.approx(
        100.0 * (1.0 - dev["busy_s"] / dev["window_s"]), rel=1e-9)
    assert m["call_frames_stub"]["value"] == 4
    assert 0 < m["encode_fixed_p64_roofline"]["value"] <= 100
