"""The region encode's plain version at P = 256, 1024 and 4096 vs the JAX
package's jnp encode, on the CPU.

``limg_tpu_torch.kernels.encode_fixed.encode_blocks_reference`` (the plain
version of csrc/encode_region.cu, which the RD policy runs at levels 1-3)
and ``limg_tpu.encoder.encode_blocks`` take the same numpy-made image,
blockified at 16x16, 32x32 and 64x64 pixels, with dithering off. The port
sums each region's pixels in one halving tree, XLA in its own order, so a
rounded endpoint can move by 1 (a *flipped* region). Unflipped regions must
get the same shifts, crushed factors and decoded pixels; every endpoint is
within 1; flipped regions are counted and bounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.encoder import encode_blocks as j_encode_blocks
from limg_tpu.ops import crush as jcrush
from limg_tpu.ops import layout as jlayout

from limg_tpu_torch.config import config_from_jax
from limg_tpu_torch.kernels import encode_fixed as kmod
from limg_tpu_torch.kernels import launch
from limg_tpu_torch.ops import crush as tcrush
from limg_tpu_torch.ops import dither as tdither
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS
from tests.conftest import make_test_image

torch.set_num_threads(1)

MAX_FLIP_FRAC = 0.1     # regions with an endpoint flip, of all regions
# an image of 2-3 region rows at every size, edge-padded at 32 and 64 px
IMAGE = {256: (44, 72), 1024: (72, 112), 4096: (100, 150)}


def _image(p, channels):
    h, w = IMAGE[p]
    return make_test_image(np.random.default_rng(p + channels), h, w)[..., :channels]


def _compare(p, channels, mode, num_factors):
    img = _image(p, channels)
    bsz = int(p ** 0.5)
    jcfg = JConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                   dithering=False, num_factors=num_factors)
    cfg = config_from_jax(jcfg)
    px, mask, _ = jlayout.blockify(jnp.asarray(img), bsz)
    jres = j_encode_blocks(px, mask, jcfg, jax.random.PRNGKey(0))
    tpx, tmask, _ = layout.blockify(torch.from_numpy(img), bsz)
    assert tpx.shape[1] == p
    shifts, q, dec, dist, *eps_avg = kmod.encode_blocks_reference(
        layout.pack_channels(tpx), tmask, cfg, 0, emit_endpoints=True)

    ep_diff = np.zeros(shifts.shape[1], np.int64)
    for k, f in enumerate(ENDPOINT_FIELDS):
        d = np.abs(eps_avg[k].numpy().astype(np.int64)
                   - np.asarray(getattr(jres.decomposition, f)).astype(np.int64))
        ep_diff = np.maximum(ep_diff, d.max(axis=0))
    agree = ep_diff == 0
    print(f"P={p} ch={channels} {mode} nf={num_factors}: {(~agree).sum()} of {agree.size} "
          f"regions with an endpoint flip")
    assert ep_diff.max() <= 1
    assert (~agree).mean() <= MAX_FLIP_FRAC
    np.testing.assert_array_equal(shifts.numpy()[:, agree], np.asarray(jres.shifts)[:, agree])
    jq = np.asarray(jres.factors)
    jq_packed = jq[0] + (jq[1] << 8) + (jq[2] << 16)
    np.testing.assert_array_equal(q.numpy()[:, agree], jq_packed[:, agree])
    jdec = layout.pack_channels(torch.from_numpy(np.asarray(jres.decoded).astype(np.uint8)))
    m = tmask.numpy()
    if channels == 3:   # the decoded word's alpha byte is 0xFF
        jdec = jdec | torch.tensor(-0x1000000, dtype=torch.int32)
    np.testing.assert_array_equal(np.where(m, dec.numpy(), 0)[:, agree],
                                  np.where(m, jdec.numpy(), 0)[:, agree])
    assert torch.isfinite(dist).all() and (dist >= 0).all()
    return agree


@pytest.mark.parametrize("mode", ["ladder", "exhaustive", "guess"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("p", [256, 1024, 4096])
def test_region_encode_matches_jax(p, channels, mode):
    _compare(p, channels, mode, 3)


@pytest.mark.parametrize("num_factors", [1, 2])
@pytest.mark.parametrize("p", [256, 1024, 4096])
def test_region_encode_reduced_factors_match_jax(p, num_factors):
    _compare(p, 3, "ladder", num_factors)


def test_err_scale_shift_at_4096_pixels():
    """64x64 regions pre-scale the block error by 4, as the JAX kernel's
    ``es = 4 if P * chunks >= 2048`` (limg_tpu/pallas_kernels/
    encode_fixed.py:373) and jnp ``_err_scale_shift`` do."""
    for p in (64, 256, 1024, 4096):
        assert tcrush.err_scale_shift(p) == jcrush._err_scale_shift(p) == (4 if p == 4096 else 0)


def test_wrapper_sizes_and_keys():
    """The wrapper takes P = 64 * 4^l (levels 4 and up too: 128x128 px
    regions and larger) and nothing else, runs the plain version on the
    CPU without counting a launch, and gives each level its own dither key,
    level 0 the fixed grid's."""
    img = _image(1024, 4)
    cfg = config_from_jax(JConfig(error_factor=100, has_alpha=True, dithering=True))
    before = launch.launches.copy()
    for p in (64, 256, 1024, 4096, 16384):
        packed, mask, grid = layout.blockify_packed(torch.from_numpy(img), int(p ** 0.5))
        shifts, q, dec, dist = kmod.encode_blocks_kernel(packed, mask, cfg, 3)
        assert q.shape == dec.shape == (p, grid.num_blocks) and dist.shape == (1, grid.num_blocks)
    assert launch.launches == before
    assert [kmod.region_level(64 << 2 * lvl) for lvl in range(13)] == list(range(13))
    with pytest.raises(ValueError, match="P must be"):
        kmod.region_level(kmod.MAX_REGION_PIXELS * 4)
    for bad in (16, 128, 2048, 32768):
        with pytest.raises(ValueError, match="P must be"):
            kmod.encode_blocks_kernel(torch.zeros((bad, 4), dtype=torch.int32),
                                      torch.ones((bad, 4), dtype=torch.bool), cfg, 0)
    keys = [tdither.level_key(3, cfg.dither_seed, lvl) for lvl in range(4)]
    assert keys[0] == tdither.dither_key(3, cfg.dither_seed)
    assert len(set(keys + [tdither.coalesce_key(3, cfg.dither_seed)])) == 5
    # 8x8 blocks keep the fixed grid's counter
    bits = tdither.dither_bits(keys[0], 5, "cpu", pixels=64)
    assert torch.equal(bits, tdither.dither_bits(keys[0], 5, "cpu"))
    assert tdither.dither_bits(keys[1], 5, "cpu", pixels=256).shape == (3, 256, 5)
