"""The harness on the CPU: arguments, the result line, refusals, the files a
cell is found by, imports, and the check failing a broken timed path.

A run here skips the look for a card (``run_cell(devices=(cpu,))``) and runs
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
from h100_bench.harness import entry as entries
from h100_bench.harness import main as harness
from h100_bench.harness import spec
from h100_bench.harness import trace as tracing

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
                            devices=(torch.device("cpu"),), program=program)


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
                      window_s=1.0, pixels=199)
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
        harness.cell_devices(4)
    with pytest.raises(harness.Refused):
        harness.cell_devices(2)


def test_the_cell_gets_its_cards_in_order(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert harness.cell_devices(1) == (torch.device("cuda", 0),)
    assert harness.cell_devices(4) == tuple(torch.device("cuda", i) for i in range(4))
    # a one-card cell's traffic and entry take its card, a cell of several
    # the tuple of its cards
    assert harness.call_device(harness.cell_devices(1)) == torch.device("cuda", 0)
    cards = harness.cell_devices(2)
    assert harness.call_device(cards) == (torch.device("cuda", 0), torch.device("cuda", 1))
    # every existing cell is a one-card cell
    for name in CELLS:
        cell = spec.load_cell(name)
        assert harness.call_device(harness.cell_devices(cell.chips)) == torch.device("cuda", 0)


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
# pixels and frames of a call; a cell of several cards
# ---------------------------------------------------------------------------

def test_a_call_counts_the_pixels_and_frames_of_its_item():
    image, batch = torch.zeros(5, 7, 3, dtype=torch.uint8), torch.zeros(4, 5, 7, 3)
    assert harness.item_frames(image) == (1, 5, 7)
    assert harness.item_frames(batch) == (4, 5, 7)
    assert harness.item_pixels(image) == 35
    assert harness.item_pixels(batch) == 140
    from h100_bench.metrics import encode_mpx_s

    # same-sized images: the window's pixels are images x pixels per image
    run = harness.Run(setup_s=1.0, latencies_s=[0.01] * 3, window_s=0.5,
                      pixels=3 * harness.item_pixels(torch.zeros(()).expand(5464, 8192, 3)))
    assert encode_mpx_s.read(run) == 3 * 5464 * 8192 / 0.5 / 1e6
    run.pixels = 140 + 35 + 140
    assert encode_mpx_s.read(run) == 315 / 0.5 / 1e6


def test_a_batch_job_counts_every_frame():
    from h100_bench.counts import common, encode_fixed_p64
    from h100_bench.reference import EncodeConfig

    cfg = EncodeConfig()
    one, four = common.Job(2160, 3840, cfg), common.Job(2160, 3840, cfg, frames=4)
    assert one.frames == 1 and one.pixels == 2160 * 3840
    assert four.blocks(0) == 4 * one.blocks(0) and four.blocks(2) == 4 * one.blocks(2)
    assert four.pixels == 4 * one.pixels
    assert common.Job(21, 13, cfg, frames=3).blocks(0) == 3 * 3 * 2   # each frame padded
    assert encode_fixed_p64.bound_s("encode_fixed_p64", four) == pytest.approx(
        4 * encode_fixed_p64.bound_s("encode_fixed_p64", one), rel=1e-12)


def _x(name, cat, s, e, tid=1, **fields):
    return dict(ph="X", name=name, cat=cat, ts=float(s), dur=float(e - s), tid=tid, **fields)


def test_idle_is_read_card_by_card():
    """Card 0 busy the whole window, card 1 half of it: 25% idle. The union
    over both cards would cover the window and read 0% idle."""
    events = [
        _x(tracing.IMAGE_SPAN, "user_annotation", 0, 1000),
        _x("aten::copy_", "cpu_op", 300, 450),
        _x("k0", "kernel", 0, 600, tid=7, pid=0, args={"device": 0}),
        _x("k0", "kernel", 600, 1000, tid=7, pid=0, args={"device": 0}),
        # card 1's events name their card by pid alone
        _x("k1", "kernel", 0, 250, tid=7, pid=1),
        _x("k1", "kernel", 500, 750, tid=7, pid=1),
    ]
    tr = tracing.reduce_trace(events, frozenset(), (3,), cards=2)
    assert tr.window_s == 1000 / 1e6
    assert tr.busy_s_per_card == (1000 / 1e6, 500 / 1e6)
    assert tr.busy_s == pytest.approx(750e-6, rel=1e-12)
    assert tr.launches == 4
    assert tr.glue_s == pytest.approx({"k0": 1000e-6, "k1": 500e-6})
    # card 1's gaps, each put to the host activity at its middle
    assert tr.idle_by_host == pytest.approx({"aten::copy_": 250e-6,
                                             "host (no traced call)": 250e-6})
    from h100_bench.metrics import device_idle_share

    run = harness.Run(setup_s=1.0, latencies_s=[0.001], window_s=0.001, pixels=1,
                      trace=tr)
    assert device_idle_share.read(run) == pytest.approx(25.0, rel=1e-9)
    # a card of the cell with no operation is idle the whole window
    three = tracing.reduce_trace(events, frozenset(), (3,), cards=3)
    assert three.busy_s_per_card == (1000 / 1e6, 500 / 1e6, 0.0)
    assert three.busy_s == pytest.approx(500e-6, rel=1e-12)
    # card 0 idle: card 1's busy time stays in card 1's place
    only_1 = [e for e in events if e["name"] != "k0"]
    tr = tracing.reduce_trace(only_1, frozenset(), (3,), cards=2)
    assert tr.busy_s_per_card == (0.0, 500 / 1e6)
    assert tr.busy_s == pytest.approx(250e-6, rel=1e-12)
    # an operation on a card outside the cell is refused, not averaged in
    with pytest.raises(ValueError, match="card 1"):
        tracing.reduce_trace(events, frozenset(), (3,), cards=1)


def test_one_card_reads_as_before():
    """A one-card trace: every field the values the reduction read before
    it went card by card (worked out by hand, equal to the last bit)."""
    corr = dict(pid=0, tid=7)
    events = [
        _x(tracing.IMAGE_SPAN, "user_annotation", 0, 400),
        _x(tracing.IMAGE_SPAN, "user_annotation", 500, 1000),
        _x("aten::mul", "cpu_op", 10, 60),
        _x("cudaLaunchKernel", "cuda_runtime", 20, 30, args={"correlation": 1}),
        _x("limg::encode", "cpu_op", 70, 90),
        _x("cudaLaunchKernel", "cuda_runtime", 75, 80, args={"correlation": 2}),
        _x("cudaStreamSynchronize", "cuda_runtime", 420, 480),
        _x("cudaMemcpyAsync", "cuda_runtime", 440, 445, args={"correlation": 3}),
        _x("limg::encode", "cpu_op", 505, 520),
        _x("cudaLaunchKernel", "cuda_runtime", 510, 515, args={"correlation": 4}),
        _x("void at::native::vectorized_elementwise_kernel<4, MulFunctor>(int)", "kernel",
           100, 200, args={"device": 0, "correlation": 1}, **corr),
        _x("void (anonymous namespace)::encode_region_kernel<64, 3>(int)", "kernel",
           210, 400, args={"device": 0, "correlation": 2}, **corr),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 450, 470,
           args={"device": 0, "correlation": 3}, **corr),
        _x("void (anonymous namespace)::encode_region_kernel<64, 3>(int)", "kernel",
           600, 800, args={"device": 0, "correlation": 4}, **corr),
    ]
    tr = tracing.reduce_trace(events, frozenset({"encode_region_kernel"}), (7, 8))
    # busy [100, 200] + [210, 400] + [450, 470] + [600, 800] us
    assert tr.busy_s == 0.00051 and tr.busy_s_per_card == (0.00051,)
    assert (tr.images, tr.window_s, tr.launches, tr.host_syncs) == (2, 0.001, 4, 1)
    assert tr.port_s == {"encode_fixed_p64": 0.00039000000000000005}   # 190e-6 + 200e-6
    assert tr.glue_s == {
        "aten::mul: void at::native::vectorized_elementwise_kernel<4, MulFunctor": 0.0001,
        "cudaMemcpyAsync: Memcpy DtoH (Device -> Pageable)": 2e-05}
    # gaps [0, 100] in aten::mul, [400, 450] in the sync; [200, 210],
    # [470, 600] and [800, 1000] in no traced call
    assert tr.idle_by_host == {"aten::mul": 0.0001, "host (no traced call)": 0.00034,
                               "cudaStreamSynchronize": 5e-05}
    assert tr.traced_indices == (7, 8)


def test_a_batch_cell_on_two_devices(batch_cell):
    """The batch cell on two CPU devices: a call's pixels are its 4 frames'
    pixels, its count job has 4 frames, each device has its peak."""
    untraced, traced = batch_cell("cpu", 2**31 + 77, 0.4)
    for result in (untraced, traced):
        assert result["correct"] is True and result["failed"] == 0, result["check"]
        assert result["device"]["count"] == 2
        assert result["device"]["memory_peak_bytes_per_card"] == [0, 0]
        assert result["check"]["bpp_gap"]["value"] == 0.0
    m = untraced["metrics"]
    assert m["call_pixels_stub"]["value"] == 4 * 24 * 40
    assert m["encode_mpx_s"]["value"] > 0 and "setup_s" in m
    assert traced["metrics"]["call_frames_stub"]["value"] == 4
    assert len(traced["device"]["busy_s_per_card"]) == 2


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
