"""The benchmark's own tests: on the CPU here, the ``cuda`` ones on the card.

    python -m pytest h100_bench/tests -q                 # the CPU tests
    python -m pytest h100_bench/tests -m cuda -q         # on the card

A test that needs a card takes the ``card`` fixture (``two_cards`` for two),
which skips where torch sees none (decided in the fixture, never at import).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = Path(ROOT) / "h100_bench"
BATCH_CELL = Path(__file__).resolve().parent / "batch_cell"
BATCH_CELL_NAME = "fixed-batch-2card-stub"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (run on a machine of several cards with -m cuda)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


_RUN_BATCH_CELL = """
import argparse, json, sys, time
import torch
import limg_tpu_torch
from h100_bench.harness import main as harness
from h100_bench.harness import spec

torch.set_num_threads(1)
kind, seed, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
cell = spec.load_cell(sys.argv[4])
devices = (harness.cell_devices(cell.chips) if kind == "cuda"
           else (torch.device("cpu"),) * cell.chips)
for trace in (0, 1):
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=seconds, trace=trace)
    result, lines = harness.run_cell(args, time.perf_counter(), cell=cell, devices=devices,
                                     program=limg_tpu_torch)
    print(json.dumps(result), flush=True)
"""


@pytest.fixture
def batch_cell(tmp_path):
    """A copy of the benchmark with one more cell, added by files alone
    (``tests/batch_cell/``): two cards, a (4, H, W, 3) batch of host frames a
    call through ``parallel.mesh.encode_corpus_sharded``. Returns
    ``run(kind, seed, seconds)``: the result lines of an untraced and a
    traced run on the CPU's devices (``kind`` "cpu") or the first two cards."""
    copy = tmp_path / BENCH.name
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in BATCH_CELL.rglob("*"):
        if path.is_file() and path.parent != BATCH_CELL:
            shutil.copy(path, copy / path.relative_to(BATCH_CELL))
    bench = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
    extra = json.loads((BATCH_CELL / "benchmark.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += extra[key]
    for m in bench["per_layer"]:
        if m["name"] in extra["per_layer_also"]:
            m["workloads"] = m["workloads"] + [BATCH_CELL_NAME]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    def run(kind: str, seed: int, seconds: float) -> list:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
        p = subprocess.run([sys.executable, "-c", _RUN_BATCH_CELL, kind, str(seed),
                            str(seconds), BATCH_CELL_NAME], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        return [json.loads(line) for line in p.stdout.strip().splitlines()[-2:]]

    return run
