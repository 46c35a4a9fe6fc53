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

from chip_smoke import seeded_rows, seeded_run_buffer, seg_map
from limg_tpu_torch import EncodeConfig
from limg_tpu_torch.kernels import encode_fixed as kmod
from limg_tpu_torch.ops import layout

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
    for by, bx in ((37, 150), (1, 70), (40, 1), (130, 130)):
        plane = torch.from_numpy(seeded_rows(rng, by * bx, channels)).to(device)
        plane = plane.reshape(7 * channels, by, bx)
        got = kc.match_neighbors_kernel(plane, channels)
        torch.cuda.synchronize(device)
        for g, w in zip(got, kc.match_neighbors_reference(plane, channels)):
            assert torch.equal(g, w), (by, bx)
    assert kc.launches["match_pairs"] == before["match_pairs"] + 1
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
    got = kc.seg_mixed_all_kernel(x, seg, n_sum)
    torch.cuda.synchronize(device)
    assert torch.equal(got, kc.seg_mixed_all_reference(x, seg, n_sum))


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
