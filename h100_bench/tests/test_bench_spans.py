"""The program's spans and counters in the harness (``harness/spans.py``,
``stages.py``), on the CPU.

A synthetic Chrome trace of two images, with and without the program's
``limg.*`` spans: every field of ``trace.reduce_trace`` and every metric
reader read the same values either way (only the names of the idle gaps
may move, to the span around them); the stage rows, the host enqueue time
and the counters' readings equal hand-computed values. At test size the
program's segment counters equal the reference's run building, and
``stages.stage_run`` runs a cell end to end, also on a program without
counters.
"""

import dataclasses
import math

import pytest
import torch

import limg_tpu_torch
from h100_bench import control
from h100_bench import reference as ref
from h100_bench import stages
from h100_bench.counts.segment_encode import lane_bound
from h100_bench.harness import entry as entries
from h100_bench.harness import main as harness
from h100_bench.harness import spans as program_spans
from h100_bench.harness import spec
from h100_bench.harness import trace as tracing
from h100_bench.reference import regions as ref_regions
from limg_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

PORT_NAMES = frozenset({"fit_levels_kernel", "segment_encode_kernel"})
CPU = torch.device("cpu")


def _image_events(o: int, corr: int) -> list:
    """One image at ``o`` us: (name, cat, start, end[, correlation])."""
    host = [
        (tracing.IMAGE_SPAN, "user_annotation", 0, 1000),
        ("limg.encode_image_merged", "user_annotation", 10, 900),
        ("limg.pre.fit", "user_annotation", 20, 200),
        ("aten::mul", "cpu_op", 30, 60),
        ("cudaLaunchKernel", "cuda_runtime", 40, 50, 1),
        ("cudaLaunchKernel", "cuda_runtime", 70, 80, 2),
        ("limg.run_count_read", "user_annotation", 300, 400),
        ("aten::_local_scalar_dense", "cpu_op", 310, 390),
        ("cudaMemcpyAsync", "cuda_runtime", 320, 330, 3),
        ("cudaStreamSynchronize", "cuda_runtime", 340, 380),
        ("limg.finish.coalesce", "user_annotation", 400, 600),
        ("cudaLaunchKernel", "cuda_runtime", 410, 420, 4),
        ("limg.fetch", "user_annotation", 600, 890),
        ("aten::copy_", "cpu_op", 610, 880),
        ("cudaMemcpyAsync", "cuda_runtime", 620, 630, 5),
        ("cudaStreamSynchronize", "cuda_runtime", 630, 870),
        ("aten::copy_", "cpu_op", 920, 990),                     # the harness's own read
        ("cudaMemcpyAsync", "cuda_runtime", 930, 940, 6),
        ("cudaStreamSynchronize", "cuda_runtime", 940, 980),
    ]
    dev = [
        ("void at::native::vectorized_elementwise_kernel<4, MulFunctor>(int)", "kernel",
         100, 150, 1),
        ("void (anonymous namespace)::fit_levels_kernel<3, false>(int)", "kernel", 160, 300, 2),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 330, 340, 3),
        ("void (anonymous namespace)::segment_encode_kernel<3, 0>(int)", "kernel", 420, 570, 4),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 700, 720, 5),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 950, 960, 6),
    ]
    out = []
    for rows, tid in ((host, 1), (dev, 7)):
        for name, cat, s, e, *c in rows:
            ev = dict(ph="X", name=name, cat=cat, ts=float(o + s), dur=float(e - s), tid=tid)
            if c:
                ev["args"] = {"correlation": corr + c[0]}
            out.append(ev)
    return out


def synthetic_trace(with_spans: bool) -> list:
    events = _image_events(0, 0) + _image_events(1000, 10)
    return [e for e in events if with_spans or not e["name"].startswith("limg.")]


def _run(tr) -> harness.Run:
    from h100_bench.counts.common import Job

    run = harness.Run(setup_s=1.0, latencies_s=[0.001, 0.001], window_s=0.002,
                      pixels=2 * 64 * 64, trace=tr)
    run.bound_jobs = lambda k: Job(64, 64, ref.EncodeConfig(), 3,
                                   {"segment_encode": {"members": 300, "lanes": 4096}})
    return run


def test_reduce_trace_and_readers_read_the_same_with_program_spans():
    plain = tracing.reduce_trace(synthetic_trace(False), PORT_NAMES, (5, 6))
    spanned = tracing.reduce_trace(synthetic_trace(True), PORT_NAMES, (5, 6))
    for f in dataclasses.fields(tracing.Trace):
        if f.name != "idle_by_host":
            assert getattr(spanned, f.name) == getattr(plain, f.name), f.name
    assert math.isclose(sum(spanned.idle_by_host.values()), sum(plain.idle_by_host.values()))
    # the gaps no operation covers now name the stage around them
    assert plain.idle_by_host["host (no traced call)"] == pytest.approx(20e-6)
    assert spanned.idle_by_host["limg.pre.fit"] == pytest.approx(20e-6)
    assert "host (no traced call)" not in spanned.idle_by_host
    assert (plain.launches, plain.host_syncs, plain.images) == (12, 6, 2)
    assert plain.port_s == pytest.approx({"fit_levels": 280e-6, "segment_encode_p64": 300e-6})
    readers = sorted(p.stem for p in (spec.BENCH_DIR / "metrics").glob("[a-z]*.py"))
    read = 0
    for name in readers:
        mod = spec.load_module("metrics", name)
        a, b = mod.read(_run(plain)), mod.read(_run(spanned))
        assert a == b, name
        read += a is not None
    assert read >= 8


def test_stage_rows_and_readings_by_hand():
    sp = program_spans.reduce_spans(synthetic_trace(True))
    rows = dict(sp.stages())
    # per image, in ms: device, host self (a span less its child spans),
    # idle by the span around each gap's middle, launches, syncs
    want = {
        "limg.pre.fit": (0.19, 0.18, 0.13, 2, 0),
        "limg.run_count_read": (0.01, 0.10, 0.11, 1, 1),
        "limg.finish.coalesce": (0.15, 0.20, 0.0, 1, 0),
        "limg.fetch": (0.02, 0.29, 0.36, 1, 1),
        "limg.encode_image_merged": (0.0, 0.12, 0.0, 0, 0),
        program_spans.OUTSIDE: (0.01, 0.11, 0.02, 1, 1),
    }
    assert set(rows) == set(want)
    for name, values in want.items():
        got = tuple(rows[name][k] for k in program_spans.ROW_KEYS)
        assert got == pytest.approx(values, abs=1e-9), name
    # the stages' device time is the kernels' and the glue's
    tr = tracing.reduce_trace(synthetic_trace(True), PORT_NAMES)
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(
        (sum(tr.port_s.values()) + sum(tr.glue_s.values())) / tr.images * 1e3)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(
        (tr.window_s - tr.busy_s) / tr.images * 1e3)
    # the entry span, 890 us, less its two blocking calls (40 + 240 us)
    assert sp.enqueue_s == pytest.approx([610e-6, 610e-6])
    assert program_spans.host_enqueue_ms(sp) == pytest.approx(0.61)
    counts = [{"limg.segments.members.p64": [300], "limg.segments.lanes.p64": [4096]}] * 2
    assert program_spans.segment_lane_use(counts) == pytest.approx(100 * 600 / 8192)
    cfg = ref.EncodeConfig()
    assert program_spans.segment_roofline(counts, tr.port_s, cfg) == pytest.approx(
        100 * lane_bound(600, 8192, 64, cfg.channels, cfg)[0] / 300e-6)
    # a trace without the program's spans or counts: nothing to read
    bare = program_spans.reduce_spans(synthetic_trace(False))
    assert program_spans.host_enqueue_ms(bare) is None
    assert [r[0] for r in bare.stages()] == [program_spans.OUTSIDE]
    assert program_spans.segment_lane_use(None) is None
    assert program_spans.segment_roofline(None, tr.port_s, cfg) is None
    assert program_spans.reduce_spans([]).stages() == []


def _pool(name: str, h: int, w: int, seed: int):
    cell = spec.load_cell(name)
    gen = spec.load_module("traffic", cell.traffic["generator"])
    return cell, gen.make_pool(dict(cell.traffic, height=h, width=w, pool=1), seed, CPU)[0]


def _program_counts(cell, image, seed: int) -> dict:
    params = dict(cell.config.get("call", {}))
    cfg = entries.encode_config(limg_tpu_torch, cell.config)
    with diagnostics.record_counts() as rec:
        entries.load(cell.config).call(limg_tpu_torch, image, cfg, seed, params, CPU)
    return rec.drain()


def test_fused_counts_equal_the_reference_run_members():
    seed = 2**31 + 17
    cell, image = _pool("merged-photo-45mp", 136, 200, seed)
    counts = _program_counts(cell, image, seed)
    params = dict(cell.config.get("call", {}))
    want = entries.load(cell.config).run_members(
        ref, image, entries.encode_config(ref, cell.config), seed, params, CPU)["segment_encode"]
    assert want["members"] > 0
    assert counts == {"limg.segments.members.p64": [want["members"]],
                      "limg.segments.lanes.p64": [want["lanes"]]}


def test_dense_counts_equal_the_reference_run_building():
    """Each dense level's buffer: its members are the level's owned regions
    in a run of two or more (the reference's ``build_runs_levels``), its
    lanes every region of the level (``cap_frac`` 1, full capacity)."""
    seed = 2**31 + 23
    cell, image = _pool("dense5-photo-45mp", 136, 264, seed)
    counts = _program_counts(cell, image, seed)
    cfg = entries.encode_config(ref, cell.config)
    levels_n, ch = cell.config["call"]["num_levels"], cfg.channels
    words = ref_regions._words(ref_regions._as_image_tensor(image, CPU))
    grids, levels = ref_regions.encode_levels(words, cfg, seed, levels_n)
    alive, _ = ref_regions.merge_levels_alive(levels, grids, ch)
    owner2 = ref_regions._owner_level(alive, grids, levels_n).reshape(grids[0].blocks_y,
                                                                      grids[0].blocks_x)
    owned = [(owner2[::1 << lvl, ::1 << lvl] == lvl).reshape(-1) for lvl in range(levels_n)]
    rows = [torch.cat([lv["avg"], lv["eps"].reshape(6 * ch, -1).to(torch.float32)])
            for lv in levels]
    matches = ref_regions.neighbor_pair_matches(rows, grids, ch)
    runs = ref_regions.build_runs_levels([(owned[lvl], grids[lvl], ref_regions.SEG_CAP,
                                           matches[lvl]) for lvl in range(levels_n)])
    want = {}
    for lvl, (_, run_len) in enumerate(runs):
        p = 64 << 2 * lvl
        want[f"limg.segments.members.p{p}"] = [int((owned[lvl] & (run_len >= 2)).sum())]
        want[f"limg.segments.lanes.p{p}"] = [grids[lvl].num_blocks]
    assert counts == want
    assert want["limg.segments.members.p64"][0] > 0


@pytest.mark.parametrize("name,program", [("merged-photo-45mp", limg_tpu_torch),
                                          ("dense5-photo-45mp", limg_tpu_torch),
                                          ("fixed-photo-45mp", limg_tpu_torch),
                                          ("merged-photo-45mp", control)])
def test_stage_run_at_test_size(name, program):
    """The stage breakdown end to end on the CPU: every span of the path in
    the rows, the counts of each traced image; a program without spans or
    counters (the control, the reference in the program's place) gives the
    rows of what lies outside it alone and no readings."""
    cell = spec.load_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, height=40, width=72, pool=2))
    line = stages.stage_run(cell, 2**31 + 5, 2, 0.0, (CPU,), program)
    names = {r[0] for r in line["breakdown"]["stages"]}
    assert line["images"] == 2 and line["traced_ms_per_image"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps", "stages"}
    if program is control:
        assert names == {program_spans.OUTSIDE} and line["counts"] is None
        assert line["host_enqueue_ms_per_image"] is None and line["segment_lane_use"] is None
        return
    entry = "limg.encode_image_device" if name.startswith("fixed") else "limg.encode_image_merged"
    assert entry in names and len(names) > 3
    assert line["host_enqueue_ms_per_image"] > 0
    if name.startswith("fixed"):
        assert line["counts"] == [{}, {}] and line["segment_lane_use"] is None
    else:
        assert len(line["counts"]) == 2 and 0 <= line["segment_lane_use"] <= 100
