"""The CUDA kernel vs its plain PyTorch version, on a card.

Marked ``cuda``: these tests skip where torch sees no CUDA device and run
on the card with

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda -q

This file imports only torch, numpy and the port (the card's machine has
no JAX). Integer outputs must be bit-equal and dist equal to within 1e-6
relative (they are built to be identical: same sum order, no FMA).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_IMAGE, EDGE_SETTINGS, LARGE_REGION_LANES, LARGE_SEGMENT_SPANS,
                        LARGE_SETTINGS, RAGGED_SIZES, ROUNDS_PIXELS, ROUNDS_SETTINGS,
                        SEGMENT_LANES, every_lane_a_member, owner_segment_map,
                        region_edge_buffers, region_run_buffer, seeded_rows, seeded_run_buffer,
                        seg_fold_cases, seg_map, small_image, with_alpha)
import limg_tpu_torch
from limg_tpu_torch import EncodeConfig, bitstream
from limg_tpu_torch.kernels import encode_fixed as kmod
from limg_tpu_torch.ops import layout
from tools import record_torch_ltp1_reference as lrec
from tools import record_torch_merged_reference as mrec
from tools import record_torch_natural_reference as nrec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _blocks(h, w, ch, seed, device):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([40 + 150 * x / w, 30 + 180 * y / h,
                    128 + 90 * np.sin(x / 7.0) * np.cos(y / 5.0),
                    255 - 60 * y / h], axis=-1) + 8 * rng.standard_normal((h, w, 4))
    img = np.clip(img, 0, 255).astype(np.uint8)[..., :ch]
    t = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    if ch == 4:
        return layout.blockify_packed(t)[:2]
    px, mask, _ = layout.blockify(t)
    return layout.pack_channels(px), mask


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 2), ("ladder", 1), ("exhaustive", 3), ("guess", 3), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_kernel_matches_plain_version(device, channels, mode, num_factors, dithering):
    packed, mask = _blocks(45, 67, channels, 11, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = kmod.launches
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
    torch.cuda.synchronize(device)
    assert kmod.launches == before + 1
    want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, i
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 1), ("exhaustive", 3), ("guess", 2), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [256, 1024, 4096])
def test_region_kernel_matches_plain_version(device, p, channels, mode, num_factors, dithering):
    """csrc/encode_region.cu at each region size, on an edge-padded image."""
    words = _words(150, 203, channels, 17, device)
    packed, mask, _ = layout.blockify_words(words, int(p ** 0.5))
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = dict(kmod.launches_region)
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
    torch.cuda.synchronize(device)
    assert kmod.launches_region == {k: v + (k == p) for k, v in before.items()}
    want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, i
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("buffer", ["grid", "all-masked row and column"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [64, 256, 1024, 4096])
def test_region_kernel_at_its_edges(device, p, channels, buffer):
    """csrc/region_encode.cuh where a CTA is part-filled or a region is
    empty: 96 x 160 px leaves the last CTA with 16 of its 32 blocks at P =
    64, 4 of 8 regions at 256, 1 of 2 at 1024; a grid one region row and
    column larger than the image adds regions with no pixel inside."""
    words = _words(*EDGE_IMAGE, channels, 23, device)
    packed, mask = region_edge_buffers(words, p)[buffer]
    if buffer != "grid":
        assert not mask.any(dim=0).all()
    for mode, num_factors, dithering in EDGE_SETTINGS:
        cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                           dithering=dithering, num_factors=num_factors)
        got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
        torch.cuda.synchronize(device)
        want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, (mode, i)
            if g.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
            else:
                assert torch.equal(g, w), (mode, i)


def test_kernel_rejects_bad_inputs(device):
    packed, mask = _blocks(16, 16, 3, 1, device)
    with pytest.raises(ValueError):
        kmod.encode_blocks_kernel(packed, mask.cpu(), EncodeConfig(), 0)
    with pytest.raises(ValueError):
        kmod.encode_blocks_kernel(packed[:32].contiguous(), mask[:32], EncodeConfig(), 0)


# ---------------------------------------------------------------------------
# The fused quadtree kernels (kernels/encode_merged.py)
# ---------------------------------------------------------------------------

def _words(h, w, ch, seed, device):
    from limg_tpu_torch.regions import _words as words_of

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([40 + 150 * x / w, 30 + 180 * y / h,
                    128 + 90 * np.sin(x / 7.0) * np.cos(y / 5.0),
                    255 - 60 * y / h], axis=-1) + 8 * rng.standard_normal((h, w, 4))
    img = np.clip(img, 0, 255).astype(np.uint8)[..., :ch]
    img[: h // 3, : w // 2, :3] = [40, 90, 200]          # a flat patch that merges
    return words_of(torch.from_numpy(np.ascontiguousarray(img)).to(device))


def _assert_same(got, want):
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 1), ("exhaustive", 3), ("guess", 2), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_merged_kernels_match_plain_versions(device, channels, mode, num_factors,
                                             dithering, levels):
    from limg_tpu_torch.kernels import encode_merged as km

    words = _words(75, 101, channels, 13, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = dict(km.launches)
    fit = km.fit_levels_kernel(words, cfg, levels)
    torch.cuda.synchronize(device)
    want = km.fit_levels_reference(words, cfg, levels)
    _assert_same(fit, want)
    got = km.owner_crush_kernel(words, want.owner, want.f8_sel, want.eps_sel, cfg, levels, 5)
    torch.cuda.synchronize(device)
    _assert_same(got, km.owner_crush_reference(words, want.owner, want.f8_sel, want.eps_sel,
                                               cfg, levels, 5))
    assert km.launches == {k: v + 1 for k, v in before.items()}



# ---------------------------------------------------------------------------
# Run building and run coalescing (kernels/coalesce.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_match_kernels_match_plain_versions(device, channels):
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(channels)
    a = torch.from_numpy(seeded_rows(rng, 5000, channels)).to(device)
    b = a + (torch.rand(a.shape, device=device) < 0.3) * torch.randint(0, 6, a.shape, device=device)
    before = dict(kc.launches)
    got = kc.match_pairs_kernel(a, b, channels)
    torch.cuda.synchronize(device)
    assert got.is_cuda and torch.equal(got, kc.match_pairs_reference(a, b, channels))
    for n in (1, 31, 32, 33, 127, 128, 129):   # part-filled warps and CTAs
        got = kc.match_pairs_kernel(a[:, :n].contiguous(), b[:, :n].contiguous(), channels)
        torch.cuda.synchronize(device)
        assert torch.equal(got, kc.match_pairs_reference(a[:, :n], b[:, :n], channels)), n
    for by, bx in ((37, 150), (1, 70), (40, 1), (130, 130)):
        plane = torch.from_numpy(seeded_rows(rng, by * bx, channels)).to(device)
        plane = plane.reshape(7 * channels, by, bx)
        got = kc.match_neighbors_kernel(plane, channels)
        torch.cuda.synchronize(device)
        for g, w in zip(got, kc.match_neighbors_reference(plane, channels)):
            assert torch.equal(g, w), (by, bx)
    assert kc.launches["match_pairs"] == before["match_pairs"] + 8
    assert kc.launches["match_neighbors"] == before["match_neighbors"] + 4


@pytest.mark.parametrize("n", [1, 1000, 5000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("n_sum", [0, 1, 3])
def test_seg_scan_kernel_matches_plain_version(device, n, dtype, n_sum):
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(n + n_sum)
    seg = torch.from_numpy(seg_map(rng, n)).to(device)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2**20, 2**20, (3, n)).astype(np.int32)).to(device)
    else:
        x = torch.from_numpy((rng.standard_normal((3, n)) * 100).astype(np.float32)).to(device)
    before = kc.launches["seg_mixed_all"]
    got = kc.seg_mixed_all_kernel(x, seg, n_sum)
    torch.cuda.synchronize(device)
    assert torch.equal(got, kc.seg_mixed_all_reference(x, seg, n_sum))
    assert kc.launches["seg_mixed_all"] == before + 1


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_seg_scan_matches_plain_version(device, seed):
    """Problems of every size around the 2,048-lane tiles, int and float
    rows of sum, max and min, column problems: one launch a batch of up to
    16 problems, bit-equal to one plain chain per problem."""
    from chip_smoke import scan_batches
    from limg_tpu_torch.kernels import coalesce as kc

    for name, batch in scan_batches(np.random.default_rng(seed), device).items():
        before = kc.launches["seg_mixed_all"]
        got = kc.seg_scan(batch)
        torch.cuda.synchronize(device)
        for g, w in zip(got, kc.seg_scan_reference(batch), strict=True):
            assert g.is_cuda and torch.equal(g, w), name
        assert kc.launches["seg_mixed_all"] == before + -(-len(batch) // kc.SCAN_MAX_PROBLEMS)


@pytest.mark.parametrize("policy", ["match", "rd"])
@pytest.mark.parametrize("channels", [3, 4])
def test_run_building_scans_launch_once_per_stage(device, channels, policy):
    """An encode's run building and coalescing take three scan launches:
    every level's horizontal stage, every level's vertical stage, and the
    coalesce pass's sums (int and float ones in one launch)."""
    from chip_smoke import capture_coalesce_calls
    from limg_tpu_torch import encode_image_merged
    from limg_tpu_torch.kernels import coalesce as kc
    from tools.make_test_image import make_4k

    img = make_4k(301, 437)
    if channels == 4:
        img = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, dithering=False)
    before = kc.launches["seg_mixed_all"]
    calls = capture_coalesce_calls(lambda: encode_image_merged(
        img, cfg, merge_policy=policy, rd_lambda=0.01, device=device))["seg_scan"]
    assert kc.launches["seg_mixed_all"] == before + 3 == before + len(calls)
    for args, kwargs in calls:
        for g, w in zip(kc.seg_scan(*args, **kwargs), kc.seg_scan_reference(*args, **kwargs),
                        strict=True):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 1), ("exhaustive", 3), ("guess", 2), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_segment_encode_kernel_matches_plain_version(device, channels, mode, num_factors,
                                                     dithering):
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(channels * 10 + num_factors)
    buf = seeded_run_buffer(rng, 700, channels, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = kc.launches["segment_encode"]
    got = kc.segment_encode_kernel(*buf, cfg, 0x1234ABCD)
    torch.cuda.synchronize(device)
    assert kc.launches["segment_encode"] == before + 1
    _assert_same(got, kc.segment_encode_reference(*buf, cfg, 0x1234ABCD))


@pytest.mark.parametrize("buffer", ["edges+empty tail", "no member", "edges"])
@pytest.mark.parametrize("mode,num_factors,dithering", [
    ("ladder", 3, True), ("exhaustive", 1, False), ("guess", 2, True), ("none", 3, False),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_segment_encode_kernel_at_its_edges(device, channels, mode, num_factors, dithering,
                                            buffer):
    """Segments of 1, 31, 32, 33 and 256 members, some across the kernel's
    128-lane tiles; a tail of lanes with no member; no member at all."""
    from chip_smoke import edge_run_buffers
    from limg_tpu_torch.kernels import coalesce as kc

    buf = edge_run_buffers(np.random.default_rng(channels), channels, device)[buffer]
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    _assert_same(got, kc.segment_encode_reference(*buf, cfg, 0x5EED))


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("h,w", [(37, 200), (130, 70), (8, 8)])
def test_fit_kernel_at_ragged_squares(device, h, w, channels, natural):
    """4-level squares (one 16-warp CTA each) cut by both image edges, and
    an image of one block."""
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn

    words = _words(h, w, channels, h + w, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4)
    kernel, plain = ((kn.fit_levels_natural_kernel, kn.fit_levels_natural_reference) if natural
                     else (km.fit_levels_kernel, km.fit_levels_reference))
    for levels in (2, 3, 4):
        got = kernel(words, cfg, levels)
        torch.cuda.synchronize(device)
        _assert_same(got, plain(words, cfg, levels))


@pytest.mark.parametrize("natural", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("h,w", RAGGED_SIZES)
def test_owner_crush_kernel_at_ragged_squares(device, h, w, channels, natural):
    """Regions owned at levels 2 and 3 cut by both image edges (a flat
    corner merges up to the top level): their warps outside the grid take
    the region's owner and add nothing. Levels 2-4, q emitted and not,
    dithering off and on (chip_smoke.compare_ragged_crush, phases 2b and 2e)."""
    from chip_smoke import compare_ragged_crush
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn

    fit_plain, kernel, plain = (
        (kn.fit_levels_natural_reference, kn.owner_crush_natural_kernel,
         kn.owner_crush_natural_reference) if natural
        else (km.fit_levels_reference, km.owner_crush_kernel, km.owner_crush_reference))
    _, n_cases = compare_ragged_crush(device, fit_plain, kernel, plain, sizes=((h, w),),
                                      channels=(channels,), compare=_assert_same)
    assert n_cases == 12


@pytest.mark.parametrize("channels", [3, 4])
def test_match_neighbors_kernel_at_plane_edges(device, channels):
    """Planes of 1, 2, odd and non-multiple-of-32 blocks a side: the last
    thread of a row has no right neighbour, the last row no down one."""
    from chip_smoke import NEIGHBOR_EDGES
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(channels + 10)
    for by, bx in NEIGHBOR_EDGES:
        plane = torch.from_numpy(seeded_rows(rng, by * bx, channels)).to(device)
        plane = plane.reshape(7 * channels, by, bx)
        got = kc.match_neighbors_kernel(plane, channels)
        torch.cuda.synchronize(device)
        for g, w in zip(got, kc.match_neighbors_reference(plane, channels)):
            assert torch.equal(g, w), (by, bx)


# ---------------------------------------------------------------------------
# The natural-layout pair (kernels/encode_natural.py) and the segment crush
# evaluation (kernels/crush_eval.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 1), ("exhaustive", 3), ("guess", 2), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_natural_kernels_match_plain_versions(device, channels, mode, num_factors,
                                              dithering, levels):
    from limg_tpu_torch.kernels import encode_natural as kn

    words = _words(75, 101, channels, 13, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = dict(kn.launches)
    fit = kn.fit_levels_natural_kernel(words, cfg, levels)
    torch.cuda.synchronize(device)
    want = kn.fit_levels_natural_reference(words, cfg, levels)
    _assert_same(fit, want)
    args = (words, want.owner, want.f8_sel, want.eps_sel, cfg, levels, 5, not dithering)
    got = kn.owner_crush_natural_kernel(*args)
    torch.cuda.synchronize(device)
    _assert_same(got, kn.owner_crush_natural_reference(*args))
    assert kn.launches == {k: v + 1 for k, v in before.items()}


@pytest.mark.parametrize("k", [1, 8, 27, 729])
@pytest.mark.parametrize("p", [64, 256])
@pytest.mark.parametrize("channels", [3, 4])
def test_crush_eval_kernel_matches_plain_version(device, channels, p, k):
    from limg_tpu_torch.kernels import crush_eval as kce
    from tools.record_torch_natural_reference import crush_eval_inputs

    packed, mask, f8p, eps, cands = crush_eval_inputs(channels, n=333, k=k, seed=p)
    if p == 256:
        packed, mask, f8p = (np.concatenate([a] * 4) for a in (packed, mask, f8p))
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in (packed, mask, f8p, eps, cands)]
    before = kce.launches["crush_eval_rows"]
    got = kce.crush_eval_rows_kernel(*ins, channels)
    torch.cuda.synchronize(device)
    assert kce.launches["crush_eval_rows"] == before + 1
    for g, w in zip(got, kce.crush_eval_rows_reference(*ins, channels)):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("table", ["sweep", "exhaustive chunk", "guess", "floors",
                                   "duplicates", "200 rows"])
@pytest.mark.parametrize("p", [64, 256])
@pytest.mark.parametrize("channels", [3, 4])
def test_crush_eval_kernel_matches_plain_version_on_tables(device, channels, p, table):
    """The search's stride-0 tables (evaluation plans), one launch per 128
    rows, on a ragged N with an all-masked block."""
    from limg_tpu_torch.kernels import crush_eval as kce
    from limg_tpu_torch.ops.crush import GUESS_TRIPLES, _const_cands
    from tools.record_torch_natural_reference import crush_eval_inputs

    rng = np.random.default_rng(p + channels)
    rows = {
        "sweep": [tuple(s if ax == a else 0 for ax in range(3)) for a in range(3) for s in range(9)],
        "exhaustive chunk": [(5, b, c) for b in range(9) for c in range(9)],
        "guess": list(GUESS_TRIPLES),
        "floors": [(0, 0, 0)],
        "duplicates": [tuple(int(v) for v in rng.integers(0, 12, 3))] * 3
                      + [tuple(int(v) for v in t) for t in rng.integers(0, 9, (16, 3))],
        "200 rows": [tuple(int(v) for v in t) for t in rng.integers(0, 9, (200, 3))],
    }[table]
    packed, mask, f8p, eps, _ = crush_eval_inputs(channels, n=333, k=1, seed=p)
    if p == 256:
        packed, mask, f8p = (np.concatenate([a] * 4) for a in (packed, mask, f8p))
    mask = mask.copy()
    mask[:, 100] = 0
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in (packed, mask, f8p, eps)]
    cands = _const_cands(rows, 333, device)
    before = kce.launches["crush_eval_rows"]
    got = kce.crush_eval_rows_kernel(*ins, cands, channels)
    torch.cuda.synchronize(device)
    assert kce.launches["crush_eval_rows"] == before + -(-len(rows) // kce.MAX_STEPS)
    for g, w in zip(got, kce.crush_eval_rows_reference(*ins, cands, channels)):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 1), ("exhaustive", 3), ("guess", 2), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_composed_segment_encode_matches_segment_kernel(device, channels, mode, num_factors,
                                                        dithering):
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import crush_eval as kce

    rng = np.random.default_rng(channels * 10 + num_factors)
    buf = seeded_run_buffer(rng, 700, channels, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = kce.launches["crush_eval_rows"]
    got = kc.segment_encode_composed(*buf, cfg, 0x1234ABCD)
    torch.cuda.synchronize(device)
    assert (kce.launches["crush_eval_rows"] > before) == (mode != "none")
    _assert_same(got, kc.segment_encode_kernel(*buf, cfg, 0x1234ABCD))


@pytest.mark.parametrize("name", lrec.STATE_CASES)
def test_ltp1_stream_of_the_card_encode_is_jaxs(device, name):
    """The port's encode of a fixture case on the card serializes to the
    stream JAX recorded from its own state
    (tests/fixtures/torch_port_ltp1_reference.json), entropy on and off,
    from the NumPy state and from the state left on the card."""
    make, levels, over, coalesce, _ = nrec.CASES[name]
    cfg = EncodeConfig(**mrec.config_kwargs(over))
    img = make()
    out, state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels,
                                                    coalesce=coalesce, return_state=True,
                                                    device=device)
    on_card = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
               for k, v in state.items()}
    for key, entropy in lrec.ENTROPY.items():
        blob = bitstream.serialize_from_state(state, cfg, entropy=entropy)
        assert lrec.digest(blob) == lrec.reference_streams()[name][key]
        assert bitstream.serialize_from_state(on_card, cfg, entropy=entropy) == blob
        np.testing.assert_array_equal(bitstream.deserialize(blob)[0], out["decoded"])


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors", [
    ("ladder", 3), ("ladder", 2), ("exhaustive", 1), ("guess", 3), ("none", 3),
])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [256, 1024, 4096])
def test_segment_encode_kernel_at_large_regions(device, p, channels, mode, num_factors,
                                                dithering):
    """The segment encode at the dense levels' region sizes, bit-equal to its
    plain version; at P = 4096 lane 0 is a saturated region whose unscaled
    error sum passes 2^31."""
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(p + channels)
    n = SEGMENT_LANES[p]
    buf = region_run_buffer(rng, p, n, channels, device, empty_tail=n // 6, saturate=p == 4096)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    name = kc.segment_kernel_name(p)
    before = kc.launches[name]
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    assert kc.launches[name] == before + 1
    for f in got._fields:
        assert torch.equal(getattr(got, f).contiguous(), getattr(want, f).contiguous()), f


def _cluster_edge_buffer(case, channels, device):
    """(P, buffer) of a case at the cluster design's edges."""
    rng = np.random.default_rng(len(case) + channels)
    if case == "every lane a member, one a segment":
        return 1024, every_lane_a_member(rng, 1024, 48, channels, device)
    if case == "a SEG_CAP-region segment at P = 4096":
        return 4096, region_run_buffer(rng, 4096, 259, channels, device, spans=[1, 256, 2],
                                       empty_tail=2, saturate=True)
    if case == "single regions at P = 65,536":
        return 65536, every_lane_a_member(rng, 65536, 3, channels, device)
    if case == "single regions at P = 262,144":
        return 262144, every_lane_a_member(rng, 262144, 2, channels, device)
    assert case == "a saturated region, its error sum wrapping"
    return 65536, region_run_buffer(rng, 65536, 4, channels, device, spans=[1, 3],
                                    saturate=True)


@pytest.mark.parametrize("mode,num_factors,dithering", [
    ("ladder", 3, True), ("ladder", 1, False), ("exhaustive", 2, True), ("guess", 3, False),
    ("none", 3, True),
])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("case", [
    "every lane a member, one a segment", "a SEG_CAP-region segment at P = 4096",
    "single regions at P = 65,536", "single regions at P = 262,144",
    "a saturated region, its error sum wrapping",
])
def test_segment_encode_kernel_at_cluster_edges(device, case, channels, mode, num_factors,
                                                dithering):
    """The cluster design (csrc/segment_cluster.cuh) where its plan changes:
    the most listed segments, a segment whose regions a warp streams
    through its stage, a region over every warp of a 16-CTA cluster, and a
    saturated region whose int32 block-error sum wraps."""
    from limg_tpu_torch.kernels import coalesce as kc

    p, buf = _cluster_edge_buffer(case, channels, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    name = kc.segment_kernel_name(p)
    before = kc.launches[name]
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    assert kc.launches[name] == before + 1
    for f in got._fields:
        assert torch.equal(getattr(got, f).contiguous(), getattr(want, f).contiguous()), f


@pytest.mark.parametrize("mode,num_factors,dithering", ROUNDS_SETTINGS)
@pytest.mark.parametrize("channels", [3, 4])
def test_segment_encode_kernel_over_rounds_of_items(device, channels, mode, num_factors,
                                                    dithering):
    """The cluster design at level 9 (P = 16,777,216), where a region has
    more items than a 16-CTA cluster has warps and its items take several
    rounds: a saturated single-region segment whose int32 error sum wraps,
    and a segment of two regions."""
    from limg_tpu_torch.kernels import coalesce as kc

    buf = region_run_buffer(np.random.default_rng(channels), ROUNDS_PIXELS, 3, channels, device,
                            spans=[1, 2], saturate=True)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    name = kc.segment_kernel_name(ROUNDS_PIXELS)
    before = kc.launches[name]
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    assert kc.launches[name] == before + 1
    for f in got._fields:
        assert torch.equal(getattr(got, f).contiguous(), getattr(want, f).contiguous()), f


def test_ten_level_dense_encode_on_card_equals_cpu(device):
    """No cap on P: a 10-level dense encode (levels 4-9 a 1x1 grid, the
    segment encode up to P = 16,777,216) on the card equals its run on the
    CPU bit for bit."""
    img = mrec.fused_band_image()
    cfg = EncodeConfig(error_factor=100)
    card, cpu = (limg_tpu_torch.encode_image_merged(img, cfg, num_levels=10, fused=False,
                                                    device=dev) for dev in (device, "cpu"))
    assert len(card["alive_counts"]) == 10
    for key in ("decoded", "factors", "shift", "bpp", "region_id", "owner_px", "alive_counts"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    assert card["psnr"] == cpu["psnr"] and card["n_runs"] == cpu["n_runs"]


@pytest.mark.parametrize("p", [16384, 65536, 262144])
@pytest.mark.parametrize("channels", [3, 4])
def test_large_region_kernel_matches_plain_version(device, p, channels):
    """The region encode's cluster kernel (csrc/region_encode.cuh, a cluster
    of 1, 4 or 16 CTAs a region, each CTA's share of 4 chunks staged in
    shared memory) on
    seeded buffers (all- and half-masked regions, a saturated region whose
    block-error sum wraps int32 from P = 65,536 on) and on a ragged image's
    grid with an all-masked row and column, in every crush mode."""
    rng = np.random.default_rng(p + channels)
    words = _words(300, 700, channels, 29, device)
    bufs = {"seeded": region_run_buffer(rng, p, LARGE_REGION_LANES[p], channels, device,
                                        saturate=True)[:2],
            **region_edge_buffers(words, p)}
    for name, (packed, mask) in bufs.items():
        for mode, num_factors, dithering in LARGE_SETTINGS:
            cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                               dithering=dithering, num_factors=num_factors)
            before = kmod.launches_region[p]
            got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
            torch.cuda.synchronize(device)
            assert kmod.launches_region[p] == before + 1
            want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, (name, mode, i)
                if g.dtype.is_floating_point:
                    torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
                else:
                    assert torch.equal(g, w), (name, mode, i)


@pytest.mark.parametrize("mode,num_factors,dithering", ROUNDS_SETTINGS)
@pytest.mark.parametrize("channels", [3, 4])
def test_region_kernel_at_level_9(device, channels, mode, num_factors, dithering):
    """The region encode at P = 16,777,216 (level 9): each CTA's share of a
    16-CTA cluster is 256 chunks, read from device memory pass by pass; a
    saturated region whose int32 block-error sum wraps, and two seeded
    ones."""
    packed, mask = region_run_buffer(np.random.default_rng(channels), ROUNDS_PIXELS, 3,
                                     channels, device, saturate=True)[:2]
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = kmod.launches_region[ROUNDS_PIXELS]
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
    torch.cuda.synchronize(device)
    assert kmod.launches_region[ROUNDS_PIXELS] == before + 1
    want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("p", [16384, 65536])
@pytest.mark.parametrize("channels", [3, 4])
def test_large_segment_kernel_matches_plain_version(device, p, channels):
    """The segment encode at P = 16,384 and 65,536 (a cluster of 16 CTAs a
    segment) on segments of one and of several regions, a tail of lanes
    with no member and a saturated region, and with no member at all."""
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(p + channels)
    spans = LARGE_SEGMENT_SPANS[p]
    buf = region_run_buffer(rng, p, sum(spans), channels, device, spans=spans,
                            empty_tail=spans[-1], saturate=True)
    name = kc.segment_kernel_name(p)
    for b in (buf, (buf[0], torch.zeros_like(buf[1]), *buf[2:])):
        for mode, num_factors, dithering in LARGE_SETTINGS:
            cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                               dithering=dithering, num_factors=num_factors)
            before = kc.launches[name]
            got = kc.segment_encode_kernel(*b, cfg, 0x5EED)
            want = kc.segment_encode_reference(*b, cfg, 0x5EED)
            torch.cuda.synchronize(device)
            assert kc.launches[name] == before + 1
            for f in got._fields:
                assert torch.equal(getattr(got, f).contiguous(),
                                   getattr(want, f).contiguous()), (mode, f)


@pytest.mark.parametrize("levels,policy", [(1, "match"), (3, "match"), (4, "rd"), (5, "match"),
                                           (6, "rd")])
@pytest.mark.parametrize("channels", [3, 4])
def test_dense_encode_on_card_equals_cpu(device, channels, levels, policy):
    """The dense path on the card (its kernels) equals its run on the CPU
    (their plain versions) bit for bit: image, planes, stats, state and
    stream."""
    img = mrec.make_4k_lane(*mrec.SMALL, "rgba" if channels == 4 else "rgb")
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4)
    runs = [limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels, merge_policy=policy,
                                               fused=False, return_state=True, device=dev)
            for dev in (device, "cpu")]
    (card, card_state), (cpu, cpu_state) = runs
    for key in ("decoded", "factors", "shift", "bpp", "region_id", "owner_px", "endpoint_rows",
                "alive_counts", "bits_histogram"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    for key in ("psnr", "mean_bpp", "n_runs", "coalesce_stats"):
        assert card[key] == cpu[key], key
    for key in ("rows", "q"):
        np.testing.assert_array_equal(card_state[key], cpu_state[key])
    assert bitstream.serialize_from_state(card_state, cfg) == \
        bitstream.serialize_from_state(cpu_state, cfg)


def test_legacy_encode_on_card_equals_cpu(device):
    img = mrec.make_4k_lane(*mrec.SMALL, "rgba")
    cfg = limg_tpu_torch.LegacyConfig(has_alpha=True)
    card = limg_tpu_torch.encode_legacy(img, cfg, device=device)
    cpu = limg_tpu_torch.encode_legacy(img, cfg, device="cpu")
    for key in ("decoded", "factors", "col_a", "col_b", "shift", "covered"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    assert card["psnr"] == cpu["psnr"] and card["grown_px"] == cpu["grown_px"]


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
def test_sharded_corpus_and_blocks_on_card_equal_cpu(device, channels, dithering):
    """The fixed-grid corpus (8 small images, one kernel launch) and the
    block-sharded image on a one-card mesh equal the same calls on the CPU
    (the plain version) bit for bit."""
    from limg_tpu_torch.parallel import mesh

    rng = np.random.default_rng(61)
    images = np.stack([small_image(37, 61, seed=int(s)) for s in rng.integers(1000, size=8)])
    images = images if channels == 3 else np.stack([with_alpha(im) for im in images])
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, dithering=dithering)
    before = kmod.launches
    card = mesh.encode_corpus_sharded(images, cfg, n_devices=1, seed=4, device="cuda")
    assert kmod.launches == before + 1
    cpu = mesh.encode_corpus_sharded(images, cfg, n_devices=1, seed=4, device="cpu")
    for key in ("psnr", "bpp", "mean_psnr"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    card = mesh.encode_image_blocks_sharded(images[0], cfg, n_devices=1, seed=4, device="cuda")
    cpu = mesh.encode_image_blocks_sharded(images[0], cfg, n_devices=1, seed=4, device="cpu")
    np.testing.assert_array_equal(card[0], cpu[0])
    assert card[1:] == cpu[1:]


# ---------------------------------------------------------------------------
# The scatter-form segment sum, refit and crush (kernels/seg_fold.py,
# ops/segments.py with contiguous=False)
# ---------------------------------------------------------------------------

def _scatter_maps(by: int, bx: int, seed: int) -> dict:
    """Quadtree owner squares (levels 0-2, numbered in row-major block order)
    and a random map with empty segments, on a by x bx block grid."""
    rng = np.random.default_rng(seed)
    owner = np.repeat(np.repeat(rng.integers(0, 3, (-(-by // 4), -(-bx // 4))), 4, 0), 4, 1)
    nb = by * bx
    return {"owner": owner_segment_map(owner[:by, :bx]),
            "random": (rng.integers(0, nb // 4, nb).astype(np.int32), nb // 4 + 3)}


@pytest.mark.parametrize("case", range(6))
def test_seg_sum_fold_kernel_matches_plain_version(device, case):
    """The fold kernel equals the CPU's left fold bit for bit, launch after
    launch, with its plan built in the wrapper or passed in."""
    from limg_tpu_torch.kernels import seg_fold
    from limg_tpu_torch.ops.segments import fold_plan

    name, (x, seg, s) = list(seg_fold_cases(_scatter_maps(40, 60, 5), 2400).items())[case]
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    want = seg_fold.seg_sum_fold_reference(xt, st, s)
    before = seg_fold.launches["seg_sum_fold"]
    xd, sd = xt.to(device), st.to(device)
    got = [seg_fold.seg_sum_fold_kernel(xd, sd, s),
           seg_fold.seg_sum_fold_kernel(xd, sd, s, fold_plan(sd, s))]
    torch.cuda.synchronize(device)
    assert seg_fold.launches["seg_sum_fold"] == before + 2, name
    for g in got:
        assert g.is_cuda and torch.equal(g.cpu(), want), name


@pytest.mark.parametrize("mode,num_factors", [("ladder", 3), ("ladder", 2), ("exhaustive", 3),
                                              ("guess", 2), ("ladder", 1), ("none", 3)])
@pytest.mark.parametrize("kind", ["owner", "random"])
@pytest.mark.parametrize("channels", [3, 4])
def test_scatter_fit_and_crush_on_card_equal_cpu(device, channels, kind, mode, num_factors):
    """fit_segments -> factors -> find_shifts_segments(contiguous=False) on
    the card (seg_sum_fold in the fit, crush_eval_rows in the search) equal
    the same calls on the CPU bit for bit, and a second card run."""
    from limg_tpu_torch.kernels import crush_eval, seg_fold
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.fit import drop_decomposition_axes
    from limg_tpu_torch.ops.segments import find_shifts_segments, fit_segments, gather_decomp

    img = mrec.make_4k_lane(45, 67, "rgba" if channels == 4 else "rgb")
    px, mask, grid = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)))
    seg, s = _scatter_maps(grid.blocks_y, grid.blocks_x, 9)[kind]
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       num_factors=num_factors)

    def run(dev):
        p, m, sg = px.to(dev), mask.to(dev), torch.from_numpy(seg).to(dev)
        d = fit_segments(p, m, sg, s, channels)
        f8 = torch.stack(quantize_factors(*extract_factors(p, gather_decomp(d, sg), channels)))
        d_nf = drop_decomposition_axes(d, num_factors)
        return [*d, *find_shifts_segments(p, m, f8, d_nf, sg, s, cfg)]

    before = (seg_fold.launches["seg_sum_fold"], crush_eval.launches["crush_eval_rows"])
    card = run(device)
    torch.cuda.synchronize(device)
    assert seg_fold.launches["seg_sum_fold"] > before[0]
    assert (crush_eval.launches["crush_eval_rows"] > before[1]) == cfg.crush_bits
    for g, a, w in zip(card, run(device), run("cpu")):
        assert g.is_cuda and torch.equal(g, a) and torch.equal(g.cpu(), w)
    empty = torch.from_numpy(np.bincount(seg, minlength=s) == 0).to(device)
    if cfg.crush_bits and kind == "random":
        assert empty.any() and not card[-2][:, empty].any()
        assert (card[-1][empty] == 2**31 - 1).all()


@pytest.mark.parametrize("mode", ["ladder", "guess"])
def test_contiguous_segment_fit_and_crush_on_card_equal_cpu(device, mode):
    """contiguous=True on the card (the scan kernel, crush_eval_rows) equals
    the CPU, per member."""
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.segments import find_shifts_segments, fit_segments

    img = mrec.make_4k_lane(45, 67, "rgb")
    px, mask, grid = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)))
    nb = grid.num_blocks
    seg = seg_map(np.random.default_rng(8), nb, 9)
    cfg = EncodeConfig(error_factor=100, crush_mode=mode)

    def run(dev):
        p, m, sg = px.to(dev), mask.to(dev), torch.from_numpy(seg).to(dev)
        d = fit_segments(p, m, sg, nb, 3, contiguous=True)
        f8 = torch.stack(quantize_factors(*extract_factors(p, d, 3)))
        return [*d, *find_shifts_segments(p, m, f8, d, sg, nb, cfg, contiguous=True)]

    before = kc.launches["seg_mixed_all"]
    card = run(device)
    torch.cuda.synchronize(device)
    assert kc.launches["seg_mixed_all"] > before
    for g, w in zip(card, run("cpu")):
        assert torch.equal(g.cpu(), w)


def test_device_busy_ms_on_card(device):
    """device_busy_ms sums the device time of the kernels a call launches."""
    from limg_tpu_torch.kernels import seg_fold
    from limg_tpu_torch.utils.timing import device_busy_ms, profile_device

    x = torch.rand((3, 100_000), device=device)
    seg = torch.randint(0, 5000, (100_000,), device=device, dtype=torch.int32)
    ms = device_busy_ms(lambda: seg_fold.seg_sum_fold_kernel(x, seg, 5000), device=device)
    assert ms is not None and 0 < ms < 100
    prof = profile_device(lambda: seg_fold.seg_sum_fold_kernel(x, seg, 5000), device=device)
    assert any("seg_sum_fold_kernel" in k for k in prof.kernels)
