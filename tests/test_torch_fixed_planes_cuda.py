"""The fixed grid's epilogue kernel (csrc/fixed_planes.cu) vs its plain
version, on a card.

Marked ``cuda``: these tests skip where torch sees no CUDA device and run
on the card with

    python -m pytest tests/test_torch_fixed_planes_cuda.py -m cuda -q

This file imports only torch, numpy and the port (the card's machine has
no JAX). The kernel's factor planes, decoded planes and image must equal
the plain composition (``unpack_plane`` + ``torch.stack``,
``assemble_decoded``) on the same words bit for bit, in the same shapes,
dtypes and strides.
"""

import pytest
import torch

from chip_smoke import FIXED_PLANES_SIZE, fixed_planes_words, small_image, with_alpha
from limg_tpu_torch import EncodeConfig
from limg_tpu_torch.encoder import _packed_blocks, encode_blocks, encode_image_device
from limg_tpu_torch.kernels import fixed_planes as kfp
from limg_tpu_torch.kernels import launch
from limg_tpu_torch.kernels.encode_fixed import encode_blocks_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _assert_same(got, want, image_strides: bool = True):
    for name, g, w in zip(("factors", "decoded", "image"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape, name
        if name != "image" or image_strides:
            assert g.stride() == w.stride(), (name, g.stride(), w.stride())
        assert torch.equal(g, w), (name, int((g != w).sum()))


# edge blocks cut by the height, the width and both; one block; one block
# row; blocks_x a multiple of the kernel's 64-block tile and not; NB a
# multiple of it and not (1000 x 750: 125 x 94 blocks, 11,750 = 183 tiles
# and 38; 8 x 520: 65 blocks); a ragged 750 x 997 image (94 blocks a row,
# 125 rows, cut at both edges); the 4K test images' grid (480 blocks a row:
# tiles cross block rows); the benchmark's 8192 x 5464 grid
GRIDS = [(1000, 750), (750, 1000), (37, 61), (8, 8), (5, 3), (8, 520), (64, 256), (16, 512),
         (997, 750), (2160, 3840), FIXED_PLANES_SIZE]


@pytest.mark.parametrize("h,w", GRIDS)
@pytest.mark.parametrize("channels", [3, 4])
def test_kernel_matches_plain_version(device, h, w, channels):
    q, dec, grid = fixed_planes_words(h, w, channels, device, seed=h + w)
    before = launch.launches["fixed_planes"]
    got = kfp.fixed_planes_kernel(q, dec, channels, grid)
    torch.cuda.synchronize(device)
    assert launch.launches["fixed_planes"] == before + 1
    # a one-block RGBA grid: the plain assembly's reshape is then a view of
    # its uint8 planes (channel stride 64), the kernel's image contiguous
    _assert_same(got, kfp.fixed_planes_reference(q, dec, channels, grid),
                 image_strides=channels == 3 or grid.num_blocks > 1)
    # without a grid: the planes alone
    _assert_same(kfp.fixed_planes_kernel(q, dec, channels),
                 kfp.fixed_planes_reference(q, dec, channels))


@pytest.mark.parametrize("channels", [3, 4])
def test_kernel_on_the_block_encode_words(device, channels):
    """The words encode_fixed_p64 writes (dec's alpha 0xFF for RGB), taken
    from the storage behind its (64, NB) views."""
    img = small_image(45, 67)
    img = img if channels == 3 else with_alpha(img)
    packed, mask, grid = _packed_blocks(torch.from_numpy(img).to(device))
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4)
    _, q_packed, dec_packed = encode_blocks_kernel(packed, mask, cfg, 3)[:3]
    q_bm, dec_bm = q_packed.t(), dec_packed.t()
    assert q_bm.is_contiguous() and dec_bm.is_contiguous()
    got = kfp.fixed_planes_kernel(q_bm, dec_bm, channels, grid)
    _assert_same(got, kfp.fixed_planes_reference(q_bm, dec_bm, channels, grid))


def test_kernel_refuses_strided_words(device):
    q, dec, _ = fixed_planes_words(16, 24, 3, device)
    wide = torch.zeros((q.shape[0], 128), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        kfp.fixed_planes_kernel(wide[:, :64], dec, 3)
    # contiguous, but one word off the 16 bytes that the kernel's int4 loads need
    flat = torch.zeros(q.numel() + 1, dtype=torch.int32, device=device)
    shifted = flat[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        kfp.fixed_planes_kernel(q, shifted, 3)


@pytest.mark.parametrize("h,w", [(45, 67), (64, 256)])
@pytest.mark.parametrize("channels", [3, 4])
def test_encode_image_device_outputs_and_launches(device, h, w, channels):
    """One epilogue launch an encode_blocks and an encode_image_device call;
    the card's outputs in the plain composition's shapes, dtypes and
    strides, and equal to it on the card's own words."""
    img = small_image(h, w)
    img = img if channels == 3 else with_alpha(img)
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4)
    before = launch.launches["fixed_planes"]
    decoded, res, grid = encode_image_device(img, cfg, 5, device)
    torch.cuda.synchronize(device)
    assert launch.launches["fixed_planes"] == before + 1
    packed, mask, _ = _packed_blocks(torch.from_numpy(img).to(device))
    _, q_packed, dec_packed = encode_blocks_kernel(packed, mask, cfg, 5)[:3]
    want = kfp.fixed_planes_reference(q_packed.t(), dec_packed.t(), channels, grid)
    _assert_same((res.factors, res.decoded, decoded), want)
    before = launch.launches["fixed_planes"]
    alone = encode_blocks(packed, mask, cfg, 5)
    assert launch.launches["fixed_planes"] == before + 1
    _assert_same((alone.factors, alone.decoded, None), (*want[:2], None))
