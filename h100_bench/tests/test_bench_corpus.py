"""The four-card corpus cell, ``fixed-corpus-4chip``, on the CPU: its files and
metrics, a run on four CPU devices at test size through the cell's own entry,
traffic and reference, the control and faults planted in the exchange between
devices failing its check, and the readers of the host uploads on a
hand-made trace.
"""

import argparse
import dataclasses
import time

import pytest
import torch

import limg_tpu_torch
from h100_bench import control, reference
from h100_bench.counts.common import Job
from h100_bench.harness import main as harness
from h100_bench.harness import spec
from h100_bench.harness import trace as tracing
from h100_bench.metrics import h2d_link_roofline, h2d_ms_per_image
from limg_tpu_torch.parallel import mesh

CELL = "fixed-corpus-4chip"
H, W = 24, 40

torch.set_num_threads(1)


def test_the_cell_loads_with_its_metrics():
    cell = spec.load_cell(CELL)
    assert cell.chips == 4 and cell.config["entry"] == "encode_corpus_sharded"
    assert (cell.traffic["frames"], cell.traffic["height"], cell.traffic["width"]) == (32, 2160,
                                                                                       3840)
    assert cell.config["encode_config"] == spec.load_json("configs", "fixed_grid")[
        "encode_config"]
    assert [m.name for m in cell.end_to_end] == ["encode_mpx_s", "encode_ms_p95", "setup_s"]
    assert [m.name for m in cell.per_layer] == [
        "launches_per_image", "host_syncs_per_image", "glue_ms_per_image",
        "kernel_ms_per_image", "kernels_roofline", "encode_fixed_p64_roofline",
        "device_idle_share", "h2d_ms_per_image", "h2d_link_roofline"]
    assert set(cell.settings["limits"]) == {"bpp_gap", "psnr_gap", "mean_psnr_gap",
                                            "frames_off"}


def run_small(monkeypatch, program, trace: int, devices: tuple, seed: int = 2**31 + 2025,
              seconds: float = 0.4):
    """One run of the cell at test size; (result, check lines, the harness's Run)."""
    cell = spec.load_cell(CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, height=H, width=W))
    kept = []
    real = harness.Run

    def keep(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(harness, "Run", keep)
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=seconds, trace=trace)
    result, lines = harness.run_cell(args, time.perf_counter(), cell=cell, devices=devices,
                                     program=program)
    return result, lines, kept[0]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_four_devices(monkeypatch, trace):
    """Every gap 0.0 against the reference; a call is 32 frames; four
    devices, each with its peak (and, traced, its busy time)."""
    result, lines, run = run_small(monkeypatch, limg_tpu_torch, trace, (torch.device("cpu"),) * 4)
    assert result["correct"] is True and result["failed"] == 0, lines
    assert {k: c["value"] for k, c in result["check"].items()} == dict(
        bpp_gap=0.0, psnr_gap=0.0, mean_psnr_gap=0.0, frames_off=0.0)
    assert run.images == result["attempted"] > 0
    assert run.pixels == run.images * 32 * H * W
    dev = result["device"]
    assert dev["count"] == 4 and len(dev["memory_peak_bytes_per_card"]) == 4
    if trace:
        assert len(dev["busy_s_per_card"]) == 4 and run.trace.traced_indices
        assert run.bound_jobs(run.trace.traced_indices[0]).frames == 32
    else:
        assert result["metrics"]["encode_mpx_s"]["value"] > 0


def test_the_control_reads_above_a_limit(monkeypatch):
    result, lines, _ = run_small(monkeypatch, control, 0, (torch.device("cpu"),) * 4)
    assert result["correct"] is False, lines
    assert any(c["value"] > c["limit"] for c in result["check"].values())


def _shard_0_on_every_device(monkeypatch):
    upload = mesh._upload
    monkeypatch.setattr(mesh, "_upload", lambda batch, k, n_loc, dev: upload(batch, 0, n_loc, dev))


def _gather_swaps_shards_0_and_1(monkeypatch):
    gather = mesh._gather
    monkeypatch.setattr(mesh, "_gather",
                        lambda parts, devs, n: gather([parts[1], parts[0], *parts[2:]], devs, n))


def _every_shard_dithers_from_shard_0(monkeypatch):
    seed_of = mesh.image_seed
    monkeypatch.setattr(mesh, "image_seed", lambda seed, index: seed_of(seed, 0))


# faults in the exchange between devices, each planted in the port's
# parallel/mesh.py: (plant, frames of the 32 it puts wrong)
FAULTS = {"shard_0_on_every_device": (_shard_0_on_every_device, 24),
          "gather_swaps_shards_0_and_1": (_gather_swaps_shards_0_and_1, 16),
          "every_shard_dithers_from_shard_0": (_every_shard_dithers_from_shard_0, 24)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_between_devices_fails_the_check(monkeypatch, fault):
    """Each fault puts the frames of whole shards wrong, and ``frames_off``
    counts every one of them."""
    plant, wrong = FAULTS[fault]
    plant(monkeypatch)
    result, lines, _ = run_small(monkeypatch, limg_tpu_torch, 0, (torch.device("cpu"),) * 4)
    assert result["correct"] is False, lines
    assert result["check"]["frames_off"]["value"] == wrong


def _trace_run(glue_s: dict) -> harness.Run:
    cfg = reference.EncodeConfig()
    run = harness.Run(setup_s=0.0, latencies_s=[0.1, 0.1], window_s=0.2, pixels=0,
                      trace=tracing.Trace(images=2, launches=12, glue_s=glue_s,
                                          traced_indices=(5, 6)))
    run.bound_jobs = lambda k: Job(2160, 3840, cfg, frames=32)
    return run


def test_the_upload_readers_count_host_to_device_copies_alone():
    run = _trace_run({"aten::copy_: Memcpy HtoD (Pageable -> Device)": 0.15,
                      "aten::to: Memcpy HtoD (Pinned -> Device)": 0.05,
                      "aten::copy_: Memcpy DtoH (Device -> Pageable)": 0.001,
                      "aten::copy_: Memcpy PtoP (Device -> Device)": 0.002,
                      "aten::mul: void at::native::vectorized_elementwise_kernel": 0.003})
    # 0.2 s of host-to-device copies over 2 calls
    assert h2d_ms_per_image.read(run) == pytest.approx(100.0, rel=1e-12)
    # 2 calls x 32 x 2160 x 3840 x 3 B = 1,592,524,800 B in 0.2 s: 7.9626 GB/s of 64
    assert h2d_link_roofline.read(run) == pytest.approx(12.4416, rel=1e-12)


def test_the_upload_readers_read_nothing_without_copies_or_trace():
    run = _trace_run({"aten::mul: void at::native::vectorized_elementwise_kernel": 0.003})
    assert h2d_ms_per_image.read(run) == 0.0
    assert h2d_link_roofline.read(run) is None
    run.trace = None
    assert h2d_ms_per_image.read(run) is None and h2d_link_roofline.read(run) is None
