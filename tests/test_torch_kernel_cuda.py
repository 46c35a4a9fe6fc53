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

from chip_smoke import (EDGE_IMAGE, EDGE_SETTINGS, LARGE_IMAGE, LARGE_REGION_LANES,
                        LARGE_SEGMENT_SPANS, LARGE_SETTINGS, RAGGED_SIZES, ROUNDS_PIXELS,
                        ROUNDS_SETTINGS, SEGMENT_LANES, every_lane_a_member, image_run_buffer,
                        owner_segment_map, region_edge_buffers, region_run_buffer, seeded_rows,
                        seeded_run_buffer, seg_fold_cases, seg_map, small_image, with_alpha)
import limg_tpu_torch
from limg_tpu_torch import EncodeConfig, bitstream
from limg_tpu_torch.kernels import encode_fixed as kmod
from limg_tpu_torch.kernels import launch
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
    before = launch.launches["encode_fixed_p64"]
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
    torch.cuda.synchronize(device)
    assert launch.launches["encode_fixed_p64"] == before + 1
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
    before = launch.launches.copy()
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
    torch.cuda.synchronize(device)
    assert launch.launches - before == {f"encode_region_p{p}": 1}
    want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, i
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("image", ["synthetic", "make_4k"])
@pytest.mark.parametrize("buffer", ["grid", "all-masked row and column"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [64, 256, 1024, 4096])
def test_region_kernel_at_its_edges(device, p, channels, buffer, image):
    """csrc/region_encode.cuh where a CTA is part-filled or a region is
    empty: 96 x 160 px leaves the last CTA with 16 of its 32 blocks at P =
    64, 4 of 8 regions at 256, 1 of 2 at 1024; a grid one region row and
    column larger than the image adds regions with no pixel inside."""
    if image == "synthetic":
        words = _words(*EDGE_IMAGE, channels, 23, device)
    else:
        words = _image_words(f"{EDGE_IMAGE[0]}x{EDGE_IMAGE[1]}", channels, device)
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


def _assert_same(got, want, case=()):
    """Kernel outputs (a tuple, named or not; None where not emitted) equal
    the plain version's: integers bit for bit, floats within 1e-6 relative."""
    names = getattr(want, "_fields", range(len(want)))
    for name, g, w in zip(names, got, want, strict=True):
        if w is None:
            assert g is None, (case, name)
            continue
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype, (case, name)
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), (case, name)


# crush settings held on the test images: every mode at num_factors 3, the
# ladder at 1 and 2, dithering off and on; exhaustive at 1 and guess at 2
SETTINGS = ([(mode, 3, dith) for mode in ("ladder", "exhaustive", "guess", "none")
             for dith in (False, True)]
            + [("ladder", nf, dith) for nf in (1, 2) for dith in (False, True)]
            + [("exhaustive", 1, False), ("guess", 2, True)])
# the segment encode's settings on seeded, edge and real run buffers, and
# its ladder at K = 1 and 16 and at error factor 10 (K, error factor)
SEGMENT_SETTINGS = [("ladder", 3, False), ("ladder", 3, True), ("exhaustive", 1, False),
                    ("guess", 2, True), ("none", 3, False), ("ladder", 2, True)]
SEGMENT_LADDER_ENDS = ((1, 100), (16, 100), (8, 10))


def _image(name: str) -> np.ndarray:
    """A test image by "HxW": the noisy gradient of ``small_image`` at 40 x 56
    and 70 x 90, else a crop of tools/make_test_image's 4K photo."""
    from tools.make_test_image import make_4k

    h, w = map(int, name.split("x"))
    return small_image(h, w) if (h, w) in ((40, 56), (70, 90)) else make_4k(h, w)


def _image_words(name: str, channels: int, device):
    """The (H, W) words of ``_image(name)``, RGB or RGBA (gradient alpha)."""
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.regions import _words as words_of

    rgb = _image(name)
    return words_of(_as_image_tensor(rgb if channels == 3 else with_alpha(rgb), device))


def _cfg(channels: int, mode: str, num_factors: int, dithering: bool) -> EncodeConfig:
    return EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                        dithering=dithering, num_factors=num_factors)


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
    before = launch.launches.copy()
    fit = km.fit_levels_kernel(words, cfg, levels)
    torch.cuda.synchronize(device)
    want = km.fit_levels_reference(words, cfg, levels)
    _assert_same(fit, want)
    got = km.owner_crush_kernel(words, want.owner, want.f8_sel, want.eps_sel, cfg, levels, 5)
    torch.cuda.synchronize(device)
    _assert_same(got, km.owner_crush_reference(words, want.owner, want.f8_sel, want.eps_sel,
                                               cfg, levels, 5))
    assert launch.launches - before == {"fit_levels": 1, "owner_crush": 1}



# ---------------------------------------------------------------------------
# Run building and run coalescing (kernels/coalesce.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 4])
def test_match_kernels_match_plain_versions(device, channels):
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(channels)
    a = torch.from_numpy(seeded_rows(rng, 16132, channels)).to(device)
    b = a + (torch.rand(a.shape, device=device) < 0.3) * torch.randint(0, 6, a.shape, device=device)
    before = launch.launches.copy()
    got = kc.match_pairs_kernel(a, b, channels)
    torch.cuda.synchronize(device)
    assert got.is_cuda and torch.equal(got, kc.match_pairs_reference(a, b, channels))
    # part-filled warps and CTAs, and many CTAs
    for n in (1, 31, 32, 33, 127, 128, 129, 3000):
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
    assert launch.launches["match_pairs"] == before["match_pairs"] + 9
    assert launch.launches["match_neighbors"] == before["match_neighbors"] + 4


@pytest.mark.parametrize("n", [1, 1000, 5000, 129600])
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
    before = launch.launches["seg_mixed_all"]
    got = kc.seg_mixed_all_kernel(x, seg, n_sum)
    torch.cuda.synchronize(device)
    assert torch.equal(got, kc.seg_mixed_all_reference(x, seg, n_sum))
    assert launch.launches["seg_mixed_all"] == before + 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_seg_scan_matches_plain_version(device, seed):
    """Problems of every size around the 2,048-lane tiles, int and float
    rows of sum, max and min, column problems: one launch a batch of up to
    16 problems, bit-equal to one plain chain per problem."""
    from chip_smoke import scan_batches
    from limg_tpu_torch.kernels import coalesce as kc

    for name, batch in scan_batches(np.random.default_rng(seed), device).items():
        before = launch.launches["seg_mixed_all"]
        got = kc.seg_scan(batch)
        torch.cuda.synchronize(device)
        for g, w in zip(got, kc.seg_scan_reference(batch), strict=True):
            assert g.is_cuda and torch.equal(g, w), name
        assert launch.launches["seg_mixed_all"] == before + -(-len(batch) // kc.SCAN_MAX_PROBLEMS)


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
    before = launch.launches["seg_mixed_all"]
    calls = capture_coalesce_calls(lambda: encode_image_merged(
        img, cfg, merge_policy=policy, rd_lambda=0.01, device=device))["seg_scan"]
    assert launch.launches["seg_mixed_all"] == before + 3 == before + len(calls)
    for args, kwargs in calls:
        for g, w in zip(kc.seg_scan(*args, **kwargs), kc.seg_scan_reference(*args, **kwargs),
                        strict=True):
            assert torch.equal(g, w)


# crush settings of the segment encode's tests: mode, num_factors, ladder K
# (1 and MAX_LADDER_K = 16 at its ends) and an error factor (10: small
# shifts, so that verified ladder candidates are often one-axis sweeps,
# whose values the kernel takes from its sweep pass)
SEGMENT_CRUSH = [("ladder", 3, 8, 100), ("ladder", 1, 8, 100), ("exhaustive", 3, 8, 100),
                 ("guess", 2, 8, 100), ("none", 3, 8, 100), ("ladder", 3, 1, 100),
                 ("ladder", 2, 16, 100), ("ladder", 3, 8, 10), ("ladder", 3, 16, 10)]


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode,num_factors,ladder_k,error_factor", SEGMENT_CRUSH)
@pytest.mark.parametrize("channels", [3, 4])
def test_segment_encode_kernel_matches_plain_version(device, channels, mode, num_factors,
                                                     ladder_k, error_factor, dithering):
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(channels * 10 + num_factors)
    buf = seeded_run_buffer(rng, 700, channels, device)
    cfg = EncodeConfig(error_factor=error_factor, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors, ladder_k=ladder_k)
    before = launch.launches["segment_encode_p64"]
    got = kc.segment_encode_kernel(*buf, cfg, 0x1234ABCD)
    torch.cuda.synchronize(device)
    assert launch.launches["segment_encode_p64"] == before + 1
    _assert_same(got, kc.segment_encode_reference(*buf, cfg, 0x1234ABCD))


@pytest.mark.parametrize("buffer", ["edges+empty tail", "no member", "edges"])
@pytest.mark.parametrize("mode,num_factors,dithering,ladder_k", [
    ("ladder", 3, True, 8), ("exhaustive", 1, False, 8), ("guess", 2, True, 8),
    ("none", 3, False, 8), ("ladder", 2, False, 1), ("ladder", 3, False, 16),
    ("ladder", 3, False, 8), ("ladder", 2, True, 8),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_segment_encode_kernel_at_its_edges(device, channels, mode, num_factors, dithering,
                                            ladder_k, buffer):
    """Segments of 1, 31, 32, 33 and 256 members, some across the kernel's
    128-lane tiles; a tail of lanes with no member; no member at all."""
    from chip_smoke import edge_run_buffers
    from limg_tpu_torch.kernels import coalesce as kc

    buf = edge_run_buffers(np.random.default_rng(channels), channels, device)[buffer]
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors, ladder_k=ladder_k)
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
    before = launch.launches.copy()
    fit = kn.fit_levels_natural_kernel(words, cfg, levels)
    torch.cuda.synchronize(device)
    want = kn.fit_levels_natural_reference(words, cfg, levels)
    _assert_same(fit, want)
    args = (words, want.owner, want.f8_sel, want.eps_sel, cfg, levels, 5, not dithering)
    got = kn.owner_crush_natural_kernel(*args)
    torch.cuda.synchronize(device)
    _assert_same(got, kn.owner_crush_natural_reference(*args))
    assert launch.launches - before == {"fit_levels_natural": 1, "owner_crush_natural": 1}


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
    before = launch.launches["crush_eval_rows"]
    got = kce.crush_eval_rows_kernel(*ins, channels)
    torch.cuda.synchronize(device)
    assert launch.launches["crush_eval_rows"] == before + 1
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
    before = launch.launches["crush_eval_rows"]
    got = kce.crush_eval_rows_kernel(*ins, cands, channels)
    torch.cuda.synchronize(device)
    assert launch.launches["crush_eval_rows"] == before + -(-len(rows) // kce.MAX_STEPS)
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

    rng = np.random.default_rng(channels * 10 + num_factors)
    buf = seeded_run_buffer(rng, 700, channels, device)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors)
    before = launch.launches["crush_eval_rows"]
    got = kc.segment_encode_composed(*buf, cfg, 0x1234ABCD)
    torch.cuda.synchronize(device)
    assert (launch.launches["crush_eval_rows"] > before) == (mode != "none")
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
@pytest.mark.parametrize("mode,num_factors,ladder_k,error_factor", [
    ("ladder", 3, 8, 100), ("ladder", 2, 8, 100), ("exhaustive", 1, 8, 100),
    ("guess", 3, 8, 100), ("none", 3, 8, 100), ("ladder", 3, 1, 100), ("ladder", 2, 16, 100),
    ("ladder", 3, 16, 10), ("guess", 2, 8, 100), ("ladder", 3, 16, 100), ("ladder", 3, 8, 10),
])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [256, 1024, 4096])
def test_segment_encode_kernel_at_large_regions(device, p, channels, mode, num_factors,
                                                ladder_k, error_factor, dithering):
    """The segment encode at the dense levels' region sizes, bit-equal to its
    plain version; at P = 4096 lane 0 is a saturated region whose unscaled
    error sum passes 2^31."""
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(p + channels)
    n = SEGMENT_LANES[p]
    buf = region_run_buffer(rng, p, n, channels, device, empty_tail=n // 6, saturate=p == 4096)
    cfg = EncodeConfig(error_factor=error_factor, has_alpha=channels == 4, crush_mode=mode,
                       dithering=dithering, num_factors=num_factors, ladder_k=ladder_k)
    name = f"segment_encode_p{p}"
    before = launch.launches[name]
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    assert launch.launches[name] == before + 1
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
    name = f"segment_encode_p{p}"
    before = launch.launches[name]
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    assert launch.launches[name] == before + 1
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
    name = f"segment_encode_p{ROUNDS_PIXELS}"
    before = launch.launches[name]
    got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    torch.cuda.synchronize(device)
    assert launch.launches[name] == before + 1
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
    grid with an all-masked row and column (a seeded image and a make_4k
    crop), and at P = 65,536 on one region alone, in every crush mode."""
    rng = np.random.default_rng(p + channels)
    words = _words(*LARGE_IMAGE, channels, 29, device)
    seeded = region_run_buffer(rng, p, LARGE_REGION_LANES[p], channels, device, saturate=True)
    image = _image_words(f"{LARGE_IMAGE[0]}x{LARGE_IMAGE[1]}", channels, device)
    bufs = {"seeded": seeded[:2], **region_edge_buffers(words, p),
            **{f"make_4k {k}": b for k, b in region_edge_buffers(image, p).items()}}
    if p == 65536:   # the saturated region alone: one cluster
        bufs["one region"] = tuple(t[:, :1].contiguous() for t in seeded[:2])
    for name, (packed, mask) in bufs.items():
        for mode, num_factors, dithering in LARGE_SETTINGS:
            cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                               dithering=dithering, num_factors=num_factors)
            before = launch.launches[f"encode_region_p{p}"]
            got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
            torch.cuda.synchronize(device)
            assert launch.launches[f"encode_region_p{p}"] == before + 1
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
    before = launch.launches[f"encode_region_p{ROUNDS_PIXELS}"]
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 5, emit_endpoints=True)
    torch.cuda.synchronize(device)
    assert launch.launches[f"encode_region_p{ROUNDS_PIXELS}"] == before + 1
    want = kmod.encode_blocks_reference(packed, mask, cfg, 5, emit_endpoints=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
        else:
            assert torch.equal(g, w), i


@pytest.mark.parametrize("p", [16384, 65536, 262144])
@pytest.mark.parametrize("channels", [3, 4])
def test_large_segment_kernel_matches_plain_version(device, p, channels):
    """The segment encode at P = 16,384, 65,536 and 262,144 (a cluster of
    16 CTAs a segment) on segments of one and of several regions, a tail of
    lanes with no member and a saturated region, with no member at all,
    and on single regions whose every pixel is a member."""
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(p + channels)
    spans = LARGE_SEGMENT_SPANS[p]
    buf = region_run_buffer(rng, p, sum(spans), channels, device, spans=spans,
                            empty_tail=spans[-1], saturate=True)
    name = f"segment_encode_p{p}"
    for b in (buf, (buf[0], torch.zeros_like(buf[1]), *buf[2:]),
              every_lane_a_member(rng, p, len(spans), channels, device)):
        for mode, num_factors, dithering in LARGE_SETTINGS:
            cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                               dithering=dithering, num_factors=num_factors)
            before = launch.launches[name]
            got = kc.segment_encode_kernel(*b, cfg, 0x5EED)
            want = kc.segment_encode_reference(*b, cfg, 0x5EED)
            torch.cuda.synchronize(device)
            assert launch.launches[name] == before + 1
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
    before = launch.launches["encode_fixed_p64"]
    card = mesh.encode_corpus_sharded(images, cfg, n_devices=1, seed=4, device="cuda")
    assert launch.launches["encode_fixed_p64"] == before + 1
    cpu = mesh.encode_corpus_sharded(images, cfg, n_devices=1, seed=4, device="cpu")
    for key in ("psnr", "bpp", "mean_psnr"):
        np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
    card = mesh.encode_image_blocks_sharded(images[0], cfg, n_devices=1, seed=4, device="cuda")
    cpu = mesh.encode_image_blocks_sharded(images[0], cfg, n_devices=1, seed=4, device="cpu")
    np.testing.assert_array_equal(card[0], cpu[0])
    assert card[1:] == cpu[1:]


def _cards(least: int) -> int:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < least:
        pytest.skip(f"needs {least} CUDA cards (run on a machine of {least} with -m cuda)")
    return count


def _frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.stack([small_image(h, w, seed=seed + i) for i in range(n)])


def test_staged_upload_equals_to(device):
    """A shard of just over three rings of chunks, the last chunk partial,
    lands on the card byte for byte as ``.to`` puts it, from an offset of the
    batch; its staged bytes are its uploaded bytes."""
    from limg_tpu_torch.parallel import mesh, staging
    from limg_tpu_torch.utils.diagnostics import record_counts

    n = -(-staging.RING * 3 * staging.CHUNK_BYTES // (1080 * 1920 * 3))
    batch = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2 * n, 1080, 1920, 3), dtype=np.uint8))
    with record_counts() as rec:
        got = mesh._upload(batch, 1, n, device)
    assert torch.equal(got, batch[n:].to(device))
    counts = rec.drain()
    assert counts["limg.corpus.staged_bytes"] == counts["limg.corpus.upload_bytes"] == [
        batch[n:].nbytes]


def test_staged_corpus_on_four_cards_equals_pageable(monkeypatch):
    """The fixed-grid corpus on four cards through pinned buffers gives the
    totals of plain ``.to`` uploads bit for bit, and counts every uploaded
    byte as staged."""
    from limg_tpu_torch.parallel import mesh, staging
    from limg_tpu_torch.utils.diagnostics import record_counts

    _cards(4)
    images = _frames(8, 540, 960, 70)
    cfg = EncodeConfig(error_factor=100)
    with record_counts() as rec:
        staged = mesh.encode_corpus_sharded(images, cfg, n_devices=4, seed=9, device="cuda")
    counts = rec.drain()
    assert counts["limg.corpus.staged_bytes"] == counts["limg.corpus.upload_bytes"] == [
        images.nbytes // 4] * 4
    monkeypatch.setattr(staging, "staged", lambda src, dev: False)
    with record_counts() as rec:
        plain = mesh.encode_corpus_sharded(images, cfg, n_devices=4, seed=9, device="cuda")
    assert "limg.corpus.staged_bytes" not in rec.drain()
    for key in ("psnr", "bpp", "mean_psnr"):
        np.testing.assert_array_equal(staged[key], plain[key], err_msg=key)


def test_staged_corpus_encodes_a_batch_refilled_in_place_afresh():
    """On two or more cards: a batch refilled in place between calls gives
    the new frames' stats, as a fresh batch of them does."""
    from limg_tpu_torch.parallel import mesh

    cards = min(_cards(2), 4)
    cfg = EncodeConfig(error_factor=100)
    batch = _frames(2 * cards, 270, 480, 10)
    first = mesh.encode_corpus_sharded(batch, cfg, n_devices=cards, seed=2, device="cuda")
    other = _frames(2 * cards, 270, 480, 50)
    batch[...] = other
    again = mesh.encode_corpus_sharded(batch, cfg, n_devices=cards, seed=2, device="cuda")
    fresh = mesh.encode_corpus_sharded(other.copy(), cfg, n_devices=cards, seed=2,
                                       device="cuda")
    for key in ("psnr", "bpp", "mean_psnr"):
        np.testing.assert_array_equal(again[key], fresh[key], err_msg=key)
    assert not np.array_equal(first["psnr"], again["psnr"])


def test_staged_pinned_memory_stays_within_its_bound():
    """Ten corpus calls on every visible card hold at most ``RING`` pinned
    buffers of ``CHUNK_BYTES`` a card, and the pinned pool stops growing
    after the first call."""
    from limg_tpu_torch.parallel import mesh, staging

    cards = min(_cards(1), 4)
    bound = cards * staging.RING * staging.CHUNK_BYTES
    batch = _frames(4 * cards, 1080, 1920, 30)
    before = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    held = []
    for i in range(10):
        mesh.encode_corpus_sharded(batch, EncodeConfig(), n_devices=cards, seed=i,
                                   device="cuda")
        held.append(torch.cuda.host_memory_stats()["allocated_bytes.current"])
    assert held[-1] - before <= bound and held[1:] == held[:-1]
    rings = [b.nbytes for i in range(cards) for b in staging._cards[i].ring]
    assert sum(rings) == bound and all(b == staging.CHUNK_BYTES for b in rings)


# ---------------------------------------------------------------------------
# The kernels on the test images, on real run buffers and at more buffer
# shapes and block counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [64, 256, 1024, 4096])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("image", ["40x56", "256x384", "301x437"])
def test_region_kernel_on_test_images(device, image, channels, p):
    """encode_fixed_p64 and encode_region on the blocks and regions of the
    test images (aligned and edge-padded), every setting of SETTINGS."""
    packed, mask, _ = layout.blockify_words(_image_words(image, channels, device), int(p ** 0.5))
    for setting in SETTINGS:
        cfg = _cfg(channels, *setting)
        got = kmod.encode_blocks_kernel(packed, mask, cfg, 7, emit_endpoints=True)
        want = kmod.encode_blocks_reference(packed, mask, cfg, 7, emit_endpoints=True)
        torch.cuda.synchronize(device)
        _assert_same(got, want, setting)


@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("natural,image", [(False, "256x384"), (False, "70x90"),
                                           (False, "301x437"), (False, "37x200"),
                                           (True, "70x90"), (True, "301x437")])
def test_quadtree_kernels_on_test_images(device, natural, image, channels, levels):
    """The fit and owner-crush kernels of both layouts on the test images
    (4-level squares cut by the edges, a 37-px strip), every setting of
    SETTINGS; the natural crush with q emitted and not."""
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn

    fit_kernel, fit_plain, crush_kernel, crush_plain = (
        (kn.fit_levels_natural_kernel, kn.fit_levels_natural_reference,
         kn.owner_crush_natural_kernel, kn.owner_crush_natural_reference) if natural
        else (km.fit_levels_kernel, km.fit_levels_reference, km.owner_crush_kernel,
              km.owner_crush_reference))
    words = _image_words(image, channels, device)
    for i, setting in enumerate(SETTINGS):
        cfg = _cfg(channels, *setting)
        emit_q = not natural or (i // 2) % 2 == 0
        fit = fit_plain(words, cfg, levels)
        got_fit = fit_kernel(words, cfg, levels)
        args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, levels, 7, emit_q)
        got = crush_kernel(*args)
        torch.cuda.synchronize(device)
        _assert_same(got_fit, fit, (*setting, "fit"))
        _assert_same(got, crush_plain(*args), (*setting, emit_q))


@pytest.mark.parametrize("policy", ["match", "rd"])
@pytest.mark.parametrize("lane", ["rgb", "rgba"])
def test_seg_scan_on_the_4k_encodes_calls(device, lane, policy):
    """Every scan call of a 4K default and RD encode, bit-equal to the plain
    chain."""
    from chip_smoke import capture_coalesce_calls
    from limg_tpu_torch import encode_image_merged
    from limg_tpu_torch.kernels import coalesce as kc
    from tools.record_torch_reference import case_images

    img = case_images(2160, 3840)[lane]
    cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False)
    calls = capture_coalesce_calls(lambda: encode_image_merged(
        img, cfg, merge_policy=policy, rd_lambda=0.01, fetch_planes=False,
        device=device))["seg_scan"]
    assert calls
    for args, kwargs in calls:
        for g, w in zip(kc.seg_scan(*args, **kwargs), kc.seg_scan_reference(*args, **kwargs),
                        strict=True):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n", [100, 1500])
@pytest.mark.parametrize("channels", [3, 4])
def test_segment_encode_kernel_below_and_above_a_cta(device, channels, n):
    """Seeded run buffers of fewer lanes than one CTA takes and of several
    CTAs, SEGMENT_SETTINGS and the ladder's ends."""
    from limg_tpu_torch.kernels import coalesce as kc

    buf = seeded_run_buffer(np.random.default_rng(n + channels), n, channels, device)
    cfgs = [_cfg(channels, *setting) for setting in SEGMENT_SETTINGS]
    cfgs += [EncodeConfig(error_factor=ef, has_alpha=channels == 4, ladder_k=k)
             for k, ef in SEGMENT_LADDER_ENDS]
    for cfg in cfgs:
        got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
        torch.cuda.synchronize(device)
        _assert_same(got, kc.segment_encode_reference(*buf, cfg, 0x5EED))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("image", ["256x384", "301x437"])
def test_coalesce_kernels_on_image_run_buffers(device, image, channels):
    """The four run-coalescing kernels on what a 3-level default encode of a
    test image builds: match_neighbors and match_pairs on the fitted row
    planes of levels 0-2, seg_mixed_all on the run buffer's rows and the
    segment encode on the run buffer, every setting of SETTINGS."""
    from limg_tpu_torch.kernels import coalesce as kc

    rgb = _image(image)
    buf, plane = image_run_buffer(rgb if channels == 3 else with_alpha(rgb),
                                  EncodeConfig(error_factor=100, has_alpha=channels == 4,
                                               dithering=False), device)
    for lvl in range(3):
        p = plane[:, ::1 << lvl, ::1 << lvl].contiguous()
        _assert_same(kc.match_neighbors_kernel(p, channels),
                        kc.match_neighbors_reference(p, channels), ("neighbors", lvl))
        a, b = p[:, :, 1:].reshape(7 * channels, -1), p[:, :, :-1].reshape(7 * channels, -1)
        assert torch.equal(kc.match_pairs_kernel(a, b, channels),
                           kc.match_pairs_reference(a, b, channels)), lvl
    rows = torch.stack([buf[1].sum(dim=0, dtype=torch.int32), buf[3]])
    assert torch.equal(kc.seg_mixed_all_kernel(rows, buf[2], 2),
                       kc.seg_mixed_all_reference(rows, buf[2], 2))
    for setting in SETTINGS:
        cfg = _cfg(channels, *setting)
        got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
        torch.cuda.synchronize(device)
        _assert_same(got, kc.segment_encode_reference(*buf, cfg, 0x5EED))


@pytest.mark.parametrize("channels", [3, 4])
def test_composed_segment_encode_on_an_image_run_buffer(device, channels):
    """The composed re-encode (the scan and crush_eval_rows kernels) equals
    the segment kernel on a test image's run buffer, SEGMENT_SETTINGS."""
    from limg_tpu_torch.kernels import coalesce as kc

    rgb = _image("256x384")
    buf, _ = image_run_buffer(rgb if channels == 3 else with_alpha(rgb),
                              EncodeConfig(error_factor=100, has_alpha=channels == 4,
                                           dithering=False), device)
    for setting in SEGMENT_SETTINGS:
        cfg = _cfg(channels, *setting)
        got = kc.segment_encode_composed(*buf, cfg, 0x5EED)
        torch.cuda.synchronize(device)
        _assert_same(got, kc.segment_encode_kernel(*buf, cfg, 0x5EED))


def crush_eval_tables(n: int) -> dict:
    """The shift tables crush_eval_rows is held to at N blocks: the
    search's (the ladder's 27 axis sweeps, an exhaustive chunk of 81, the
    guess mode's 4 triples, the reduced-factor floors' (0, 0, 0)), a seeded
    table of 19 rows with duplicates and shifts above 8, and one of 200 rows
    (two launches; below the full 4K buffer)."""
    from limg_tpu_torch.ops.crush import GUESS_TRIPLES

    rng = np.random.default_rng(n)
    every = [(a, b, c) for a in range(9) for b in range(9) for c in range(9)]
    few = [tuple(int(v) for v in rng.integers(0, 12, 3)) for _ in range(6)]
    tables = {
        "sweep table K=27": [tuple(s if ax == a else 0 for ax in range(3))
                             for a in range(3) for s in range(9)],
        f"exhaustive chunk {n % 9} K=81": every[81 * (n % 9):81 * (n % 9 + 1)],
        "guess table K=4": list(GUESS_TRIPLES),
        "floors table K=1": [(0, 0, 0)],
        "table with duplicates K=19": [few[i] for i in rng.integers(0, 6, 19)],
    }
    if n < 129600:
        tables["table K=200"] = [tuple(int(v) for v in rng.integers(0, 9, 3))
                                 for _ in range(200)]
    return tables


@pytest.mark.parametrize("n,k", [(1, 1), (37, 8), (1000, 27), (3001, 729), (129600, 27)])
@pytest.mark.parametrize("p", [64, 256])
@pytest.mark.parametrize("channels", [3, 4])
def test_crush_eval_kernel_at_block_counts(device, channels, p, n, k):
    """crush_eval_rows on per-block triples and on the tables of
    crush_eval_tables from one block to the 4K run buffer's 129,600, one
    block all-masked."""
    from limg_tpu_torch.kernels import crush_eval as kce
    from limg_tpu_torch.ops.crush import _const_cands
    from tools.record_torch_natural_reference import crush_eval_inputs

    packed, mask, f8p, eps, cands = crush_eval_inputs(channels, n=n, k=k, seed=p + n)
    if p == 256:
        packed, mask, f8p = (np.concatenate([a] * 4) for a in (packed, mask, f8p))
    mask = mask.copy()
    mask[:, n // 2] = 0
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in (packed, mask, f8p, eps)]
    tables = {f"per-block K={k}": torch.from_numpy(cands).to(device),
              **{name: _const_cands(rows, n, device)
                 for name, rows in crush_eval_tables(n).items()}}
    for name, table in tables.items():
        got = kce.crush_eval_rows_kernel(*ins, table, channels)
        torch.cuda.synchronize(device)
        for g, w in zip(got, kce.crush_eval_rows_reference(*ins, table, channels)):
            assert g.is_cuda and torch.equal(g, w), name


@pytest.mark.parametrize("buffer", ["edges", "no member", "every lane a member"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [256, 1024, 4096])
def test_segment_encode_kernel_at_region_edges(device, p, channels, buffer):
    """The segment encode at the dense levels' region sizes on segments of
    1, 3, 31, 33 and SEG_CAP regions with a tail of lanes with no member
    (at P = 4096 lane 0 a saturated region), the same with no member at
    all, and every lane a member and a segment (the most segments listed),
    SEGMENT_SETTINGS."""
    from limg_tpu_torch.kernels import coalesce as kc

    rng = np.random.default_rng(p + channels)
    if buffer == "every lane a member":
        buf = every_lane_a_member(rng, p, SEGMENT_LANES[p], channels, device)
    else:
        spans = [1, 256, 1, 3, 31, 33, 1, 9]
        buf = region_run_buffer(rng, p, sum(spans), channels, device, spans=spans,
                                empty_tail=9, saturate=p == 4096)
        if buffer == "no member":
            buf = (buf[0], torch.zeros_like(buf[1]), *buf[2:])
    for setting in SEGMENT_SETTINGS:
        cfg = _cfg(channels, *setting)
        got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
        want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
        torch.cuda.synchronize(device)
        for f in got._fields:
            assert torch.equal(getattr(got, f).contiguous(),
                               getattr(want, f).contiguous()), (setting, f)


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
    before = launch.launches["seg_sum_fold"]
    xd, sd = xt.to(device), st.to(device)
    got = [seg_fold.seg_sum_fold_kernel(xd, sd, s),
           seg_fold.seg_sum_fold_kernel(xd, sd, s, fold_plan(sd, s))]
    torch.cuda.synchronize(device)
    assert launch.launches["seg_sum_fold"] == before + 2, name
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

    before = (launch.launches["seg_sum_fold"], launch.launches["crush_eval_rows"])
    card = run(device)
    torch.cuda.synchronize(device)
    assert launch.launches["seg_sum_fold"] > before[0]
    assert (launch.launches["crush_eval_rows"] > before[1]) == cfg.crush_bits
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

    before = launch.launches["seg_mixed_all"]
    card = run(device)
    torch.cuda.synchronize(device)
    assert launch.launches["seg_mixed_all"] > before
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
