"""The fixed grid's output epilogue (kernels/fixed_planes.py) on the CPU.

On a CPU tensor the wrapper runs its plain version, the composition the
fixed-grid encode used before the kernel: ``unpack_plane`` and
``torch.stack`` for the planes, ``assemble_decoded`` for the image. These
tests hold it to a NumPy reading of the words (each output a byte of a
word, the image the dec words in row-major pixel order with alpha 0xFF for
RGB) and hold ``encode_image_device`` on the CPU to the composition and to
the recorded JAX encode. The kernel itself runs in
tests/test_torch_fixed_planes_cuda.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from limg_tpu_torch import EncodeConfig
from limg_tpu_torch.encoder import (_as_image_tensor, _encode_blocks, _packed_blocks,
                                    encode_blocks, encode_image_device)
from limg_tpu_torch.kernels import fixed_planes as kfp
from limg_tpu_torch.kernels import launch
from limg_tpu_torch.kernels.encode_fixed import encode_blocks_reference
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.error import psnr as weighted_psnr
from tools.record_torch_reference import SIZES, case_images

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_port_reference.json")


def _words(h, w, ch, seed):
    """Seeded (NB, 64) q and dec words of an h x w grid (dec's alpha 0xFF for
    RGB, as the block encode writes it), and the grid."""
    grid = layout.grid_for(h, w)
    rng = np.random.default_rng(seed)
    q, dec = rng.integers(-2 ** 31, 2 ** 31, (2, grid.num_blocks, 64), dtype=np.int64)
    if ch == 3:
        dec |= 0xFF000000
    as_i32 = lambda a: torch.from_numpy(((a + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32))
    return as_i32(q), as_i32(dec), grid


def _numpy_image(dec_bm: np.ndarray, grid, ch: int) -> np.ndarray:
    """(H, W, 4) uint8: pixel (y, x) is word p = (y % 8) * 8 + x % 8 of block
    (y // 8) * blocks_x + x // 8, little-endian bytes, alpha 0xFF for RGB."""
    u = dec_bm.astype(np.int64) & 0xFFFFFFFF
    if ch == 3:
        u |= 0xFF000000
    y, x = np.mgrid[0:grid.height, 0:grid.width]
    words = u[(y // 8) * grid.blocks_x + x // 8, (y % 8) * 8 + x % 8]
    return np.stack([(words >> (8 * c)) & 0xFF for c in range(4)], axis=-1).astype(np.uint8)


# ragged grids: edge blocks cut by the height, by the width, by both; one
# block; a grid of 1 block row; blocks_x a multiple of the kernel's 64-block
# tile and not; NB a multiple of it and not
GRIDS = [(1000, 750), (750, 1000), (37, 61), (8, 8), (5, 3), (8, 520), (64, 256), (16, 512),
         (45, 67)]


@pytest.mark.parametrize("h,w", GRIDS)
@pytest.mark.parametrize("channels", [3, 4])
def test_plain_version_reads_the_words(h, w, channels):
    q, dec, grid = _words(h, w, channels, h * 7919 + w)
    factors, decoded, image = kfp.fixed_planes_kernel(q, dec, channels, grid)
    qn, dn = q.numpy().astype(np.int64), dec.numpy().astype(np.int64)
    want_f = np.stack([(qn.T >> (8 * c)) & 0xFF for c in range(3)])
    want_d = np.stack([(dn.T >> (8 * c)) & 0xFF for c in range(channels)])
    for got, want in ((factors, want_f), (decoded, want_d)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert image.shape == (h, w, 4) and image.dtype == torch.uint8
    np.testing.assert_array_equal(image.numpy(), _numpy_image(dec.numpy(), grid, channels))


@pytest.mark.parametrize("channels", [3, 4])
def test_plain_version_is_the_old_composition(channels):
    """The planes of today's encode_blocks and its image, strides too: RGB
    a contiguous image, RGBA the padded grid's image cropped as a view."""
    q, dec, grid = _words(37, 61, channels, 5)
    factors, decoded, image = kfp.fixed_planes_reference(q, dec, channels, grid)
    old_f = torch.stack([layout.unpack_plane(q.t(), c) for c in range(3)])
    old_d = torch.stack([layout.unpack_plane(dec.t(), c) for c in range(channels)])
    old_img = layout.unblockify(old_d.to(torch.uint8), grid)
    if channels == 3:
        old_img = torch.cat([old_img, torch.full((37, 61, 1), 0xFF, dtype=torch.uint8)], dim=-1)
    for got, old in ((factors, old_f), (decoded, old_d), (image, old_img)):
        assert got.stride() == old.stride() and torch.equal(got, old)
    assert image.is_contiguous() == (channels == 3)
    assert kfp.fixed_planes_reference(q, dec, channels)[2] is None


def test_wrapper_refuses_bad_inputs():
    q, dec, grid = _words(16, 24, 3, 1)
    with pytest.raises(ValueError, match="q_bm"):
        kfp.fixed_planes_kernel(q.t(), dec, 3)
    with pytest.raises(ValueError, match="dec_bm"):
        kfp.fixed_planes_kernel(q, dec[:-1], 3)
    with pytest.raises(ValueError, match="int32"):
        kfp.fixed_planes_kernel(q.to(torch.int64), dec, 3)
    with pytest.raises(ValueError, match="channels"):
        kfp.fixed_planes_kernel(q, dec, 2)
    with pytest.raises(ValueError, match="grid"):
        kfp.fixed_planes_kernel(q, dec, 3, layout.grid_for(24, 24))


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_image_device_on_the_cpu_is_unchanged(channels):
    """The plain route: no epilogue launch; the planes are the block
    encode's words unpacked, the image their assembly; encode_blocks and
    _encode_blocks agree, the image only with a grid."""
    img = case_images(45, 67)["rgb" if channels == 3 else "rgba"]
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4)
    before = launch.launches.copy()
    decoded, res, grid = encode_image_device(img, cfg, 3, "cpu")
    assert launch.launches == before
    packed, mask, _ = _packed_blocks(_as_image_tensor(img, torch.device("cpu")))
    outs = encode_blocks_reference(packed, mask, cfg, 3)
    for got, words, n in ((res.factors, outs[1], 3), (res.decoded, outs[2], channels)):
        assert torch.equal(got, torch.stack([layout.unpack_plane(words, c) for c in range(n)]))
    assert torch.equal(decoded, kfp.assemble_decoded(res.decoded, grid, channels))
    assert decoded.shape == (45, 67, 4) and decoded.dtype == torch.uint8
    assert res.factors.shape == (3, 64, grid.num_blocks) and res.factors.is_contiguous()
    assert res.decoded.shape == (channels, 64, grid.num_blocks) and res.decoded.is_contiguous()
    alone = encode_blocks(packed, mask, cfg, 3)
    with_grid, image = _encode_blocks(packed, mask, cfg, 3, grid)
    assert _encode_blocks(packed, mask, cfg, 3)[1] is None and torch.equal(image, decoded)
    for a, b in ((alone.factors, with_grid.factors), (alone.decoded, with_grid.decoded),
                 (alone.shifts, res.shifts)):
        assert torch.equal(a, b)
    assert launch.launches == before


@pytest.mark.parametrize("lane", ["rgb", "rgba"])
def test_encode_image_device_matches_fixture(lane):
    """encode_image_device on the CPU against the JAX encode recorded in
    tests/fixtures/torch_port_reference.json (small cut, dithering off; the
    tolerances of tests/test_torch_fixture.py: PSNR 0.02 dB, histogram L1
    0.5% of the pixels)."""
    with open(FIXTURE) as f:
        fx = json.load(f)
    ref = fx["cases"][f"small_{lane}_nodither"]
    img = case_images(*SIZES["small"])[lane]
    cfg = EncodeConfig(error_factor=fx["error_factor"], has_alpha=lane == "rgba",
                       crush_mode=fx["crush_mode"], dithering=False)
    decoded, res, _ = encode_image_device(img, cfg, fx["seed"], "cpu")
    psnr, _ = weighted_psnr(_as_image_tensor(img, torch.device("cpu")), decoded, cfg.channels)
    h, w = img.shape[:2]
    hist_l1 = int(np.abs(res.bits_histogram.numpy() - np.asarray(ref["bits_histogram"])).sum())
    assert abs(float(psnr) - ref["psnr"]) <= 0.02
    assert hist_l1 <= 0.005 * h * w
