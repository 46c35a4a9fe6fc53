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
