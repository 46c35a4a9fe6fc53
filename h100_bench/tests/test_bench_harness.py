"""The harness on the CPU: arguments, the result line, refusals, the files a
cell is found by, imports, and the check failing a broken timed path.

A run here skips the look for a card (``run_cell(device=cpu)``) and runs
each cell's traffic at a tiny frame, where the port takes its plain route.
"""

import argparse
import ast
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import limg_tpu_torch
from h100_bench import control
from h100_bench.harness import main as harness
from h100_bench.harness import spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]

torch.set_num_threads(1)


def tiny(name: str, h: int = 40, w: int = 72) -> spec.Cell:
    cell = spec.load_cell(name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, height=h, width=w))


def run_tiny(name: str, program=limg_tpu_torch, trace: int = 0, seconds: float = 0.3,
             seed: int = 2**31 + 99):
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    return harness.run_cell(args, time.perf_counter(), cell=tiny(name),
                            device=torch.device("cpu"), program=program)


# ---------------------------------------------------------------------------
# arguments and the last line
# ---------------------------------------------------------------------------

def test_arguments():
    a = harness.parse_args(["--workload", "x", "--seed", str(2**33), "--seconds", "10",
                            "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("x", 2**33, 10.0, 1)
    assert harness.parse_args(["--workload", "x", "--seed", "1", "--seconds", "2"]).trace == 0
    for bad in (["--seed", "1", "--seconds", "2"], ["--workload", "x", "--seconds", "2"],
                ["--workload", "x", "--seed", "1", "--seconds", "2", "--trace", "2"]):
        with pytest.raises(SystemExit):
            harness.parse_args(bad)


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    result, lines = run_tiny("fixed-photo-45mp", trace=trace)
    out, err = io.StringIO(), io.StringIO()
    assert harness.emit(result, lines, out, err) == 0
    last = json.loads(out.getvalue().splitlines()[-1])
    keys = list(last)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "check"
    assert ("breakdown" in last) == bool(trace)
    if trace:
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(last["device"])
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(last["device"])
    for name, c in last["check"].items():
        assert set(c) == {"value", "limit"}
    assert err.getvalue().splitlines()[-1] == "correct: true"
    if not trace:
        assert set(last["metrics"]) == {"encode_mpx_s", "setup_s"}   # too few images for p95
        for m in last["metrics"].values():
            assert m["value"] > 0 and m["unit"]


def test_p95_reads_from_200_images():
    from h100_bench.metrics import encode_ms_p95

    run = harness.Run(setup_s=1.0, latencies_s=[0.001 * (i + 1) for i in range(199)],
                      window_s=1.0, pixels_per_image=1)
    assert encode_ms_p95.read(run) is None
    run.latencies_s.append(0.2)
    assert encode_ms_p95.read(run) == pytest.approx(190.05, abs=1e-9)


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0], "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no card" in p.stderr


def test_too_few_cards_are_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(harness.Refused):
        harness.cuda_device(4)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []        # limg_tpu_torch is loaded, and allowed
    monkeypatch.setitem(sys.modules, "limg_tpu.regions", object())
    assert harness.forbidden_modules() == ["limg_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    out, err = io.StringIO(), io.StringIO()
    assert harness.emit({"correct": True}, [], out, err) == 3
    assert out.getvalue() == "" and "jaxlib, limg_tpu" in err.getvalue()


def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from pathlib import Path; from h100_bench.harness import main\n"
            "try:\n    main.import_program(Path('.'))\nexcept main.Refused as e:\n"
            "    print('refused:', e); sys.exit(2)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode == 2 and "refused" in p.stdout


# ---------------------------------------------------------------------------
# found by name
# ---------------------------------------------------------------------------

def test_every_name_in_the_benchmark_is_a_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert spec.load_json("configs", c["name"]) == json.loads((ROOT / c["file"]).read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config_name == w["config"] and cell.traffic_name == w["traffic"]
        spec.load_module("entries", cell.config["entry"])
        spec.load_module("traffic", cell.traffic["generator"])
        assert set(cell.settings["limits"]) == set(
            run_tiny_numbers(w["name"])), w["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.load_module("metrics", "no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.load_json("configs", "../BENCHMARK")


_NUMBERS = {}


def run_tiny_numbers(name):
    if name not in _NUMBERS:
        _NUMBERS[name] = run_tiny(name)[0]["check"]
    return _NUMBERS[name]


def test_every_port_kernel_label_has_its_counts_or_none():
    for label in ("encode_fixed_p64", "encode_region_p256", "encode_region_cluster",
                  "fit_levels", "owner_crush", "segment_encode_p64", "segment_encode_p1024"):
        assert spec.count_module(label) is not None, label
    assert spec.count_module("match_pairs") is None


def test_a_new_cell_and_metric_are_found_by_adding_files(tmp_path):
    """A copy of the folder with one more cell (a new workload file and
    BENCHMARK.json entry, an existing config and traffic) and one more metric
    file: the loader finds both by name, no file edited."""
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="merged-photo-45mp-copy"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="new_metric",
                                   workloads=["merged-photo-45mp-copy"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(BENCH / "workloads" / "merged-photo-45mp.json",
                tmp_path / BENCH.name / "workloads" / "merged-photo-45mp-copy.json")
    (tmp_path / BENCH.name / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    code = ("from h100_bench.harness import spec\n"
            "c = spec.load_cell('merged-photo-45mp-copy')\n"
            "assert [m.name for m in c.per_layer][-1] == 'new_metric'\n"
            "print(spec.load_module('metrics', 'new_metric').read(None))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "42.0"


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def _imported_top_names(path: Path) -> set:
    """Top-level names of every absolute import in a file, and of relative
    imports that leave ``reference/`` (as '..')."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                rel = path.parent.relative_to(BENCH / "reference") if (
                    BENCH / "reference") in path.parents else None
                if rel is not None and node.level > len(rel.parts) + 1:
                    names.add("..")
    return names


def test_no_module_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "limg_tpu"}
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 30
    for path in files:
        assert not _imported_top_names(path) & forbidden, path
        if "tests" not in path.parts:
            text = path.read_text()
            assert "bench.py" not in text and "BENCH_r" not in text, path


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert len(files) >= 20
    for path in files:
        names = _imported_top_names(path)
        assert not names & {"limg_tpu_torch", "limg_tpu", "jax", "h100_bench", ".."}, path
        assert "csrc" not in path.read_text() or "build" not in names


# ---------------------------------------------------------------------------
# the check: sound, broken, the control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_the_port_passes_its_check(name):
    result, lines = run_tiny(name)
    assert result["correct"] is True, lines
    assert all(c["value"] == 0.0 for c in result["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(name):
    """The reference in bfloat16 sums, put in the program's place."""
    result, lines = run_tiny(name, program=control)
    assert result["correct"] is False, lines


def _alter_one_answer(monkeypatch, name):
    """Alter one block's answer where the timed path produces it."""
    from limg_tpu_torch import encoder, regions

    if name.startswith("fixed"):
        real = encoder.encode_blocks_kernel

        def broken(*args, **kwargs):
            out = real(*args, **kwargs)
            out[0][0, 0] = (out[0][0, 0] + 1) % 8   # one block's crush
            return out

        monkeypatch.setattr(encoder, "encode_blocks_kernel", broken)
    elif name.startswith("merged"):
        real = regions.owner_crush_kernel

        def broken(*args, **kwargs):
            out = real(*args, **kwargs)
            out.shifts[0, 0] = (out.shifts[0, 0] + 1) % 8   # one block's crush
            return out

        monkeypatch.setattr(regions, "owner_crush_kernel", broken)
    else:
        real = regions.encode_blocks_kernel

        def broken(*args, **kwargs):
            out = real(*args, **kwargs)
            out[0][0, 0] = (out[0][0, 0] + 1) % 8   # one region's crush, every level
            return out

        monkeypatch.setattr(regions, "encode_blocks_kernel", broken)


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_fails_the_check(monkeypatch, name):
    _alter_one_answer(monkeypatch, name)
    result, lines = run_tiny(name)
    assert result["correct"] is False, lines
    assert any(c["value"] > 0 for c in result["check"].values())


def _leave_out_half(monkeypatch, name):
    """The second half of the blocks (regions) left out of the encode: their
    answers stay zero."""
    from limg_tpu_torch import encoder, regions

    mod, fname = ((encoder, "encode_blocks_kernel") if name.startswith("fixed") else
                  (regions, "owner_crush_kernel") if name.startswith("merged") else
                  (regions, "encode_blocks_kernel"))
    real = getattr(mod, fname)

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        for t in out:
            if isinstance(t, torch.Tensor) and t.ndim >= 1:
                t[..., t.shape[-1] // 2:] = 0
        return out

    monkeypatch.setattr(mod, fname, broken)


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_blocks_left_out_fails_the_check(monkeypatch, name):
    _leave_out_half(monkeypatch, name)
    result, lines = run_tiny(name)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("name", [c for c in CELLS if not c.startswith("fixed")])
def test_a_coalesce_pass_that_returns_its_state_unchanged_fails_the_check(monkeypatch, name):
    """The run coalescing step leaves every block as it found it (the fixed
    grid has no such step)."""
    from limg_tpu_torch import regions

    def unchanged(px_plane, mask_plane, seg_id, is_run, lv, *args, **kwargs):
        nb = seg_id.shape[0]
        zero = torch.zeros((), dtype=torch.int64)
        return (torch.zeros(nb, dtype=torch.bool), zero,
                dict(dropped_runs_at_capacity=zero, overflow_run_blocks=zero, rejected_runs=zero))

    monkeypatch.setattr(regions, "coalesce_segments", unchanged)
    result, lines = run_tiny(name)
    assert result["correct"] is False, lines
    assert result["check"]["runs_gap"]["value"] > result["check"]["runs_gap"]["limit"]


def test_a_failed_image_fails_the_check(monkeypatch):
    calls = {"n": 0}
    real = limg_tpu_torch.encode_image_device

    def sometimes(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("lost")
        return real(*args, **kwargs)

    monkeypatch.setattr(limg_tpu_torch, "encode_image_device", sometimes)
    result, lines = run_tiny("fixed-photo-45mp")
    assert result["failed"] == 1 and result["correct"] is False
    assert any("lost" in line for line in lines)
