"""limg_tpu_torch.legacy (the 1-factor encoder) against limg_tpu.legacy on
the CPU, on the cases of tests/test_legacy.py, dithering off: decoded
image, coverage, grown pixels, the shift, factor, endpoint and coverage
planes equal (no case flips a float rounding), PSNR within 1e-3 dB (the
port sums the error exactly, JAX in float32), and the 1-factor decode's
mod-256 wrap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu import legacy as jl
from limg_tpu.ops import layout as jlayout

from limg_tpu_torch import legacy as tl
from limg_tpu_torch.ops import layout
from tests.conftest import make_test_image

torch.set_num_threads(1)


def _gradient(h=48, w=64):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([60 + 2 * x, 40 + y, 90 + x + y, np.full((h, w), 255.0)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _flat():
    img = np.full((32, 32, 4), 99, np.uint8)
    img[..., 3] = 255
    return img


def _grow_edge():
    """tests/test_legacy.py's pixel-grow image: a gradient, noise from x = 36."""
    h, w = 40, 64
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img[..., 0] = np.clip(60 + 2 * x, 0, 255)
    img[..., 1] = np.clip(40 + y, 0, 255)
    img[..., 2] = np.clip(90 + x, 0, 255)
    noise = np.random.default_rng(1).integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[:, 36:, :3] = noise[:, 36:]
    return img


IMAGES = {
    "noise": lambda: make_test_image(np.random.default_rng(1), 48, 64),
    "gradient": _gradient,
    "flat": _flat,
    "grow_edge": _grow_edge,
    "gradient_rgb": lambda: _gradient()[..., :3].copy(),
}
CASES = [(name, alpha, grow) for name in IMAGES for alpha in (False, True)
         for grow in (True, False) if not (alpha and name == "gradient_rgb")]


@pytest.mark.parametrize("name,has_alpha,pixel_grow", CASES)
def test_encode_legacy_equals_jax(name, has_alpha, pixel_grow):
    img = IMAGES[name]()
    kw = dict(error_factor=100, has_alpha=has_alpha, dithering=False, pixel_grow=pixel_grow)
    want = jl.encode_legacy(img, jl.LegacyConfig(**kw))
    got = tl.encode_legacy(img, tl.LegacyConfig(**kw), device="cpu")
    for key in ("decoded", "factors", "col_a", "col_b", "shift", "covered"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in ("coverage", "total_block_area", "grown_px", "avg_bits"):
        assert got[key] == want[key], key
    assert got["psnr"] == want["psnr"] or abs(got["psnr"] - want["psnr"]) <= 1e-3
    # uncovered pixels keep the source
    unc = ~got["covered"]
    np.testing.assert_array_equal(got["decoded"][unc][..., :3], img[unc][..., :3])


def test_decode_1d_keeps_the_mod_256_wrap():
    """b < a on a channel wraps mod 256 instead of clamping, as JAX's
    decode_1d does (src/limg_decode.h:6-34)."""
    a = np.asarray([[200], [10], [100]], np.int32)
    b = np.asarray([[100], [240], [100]], np.int32)
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (64, 1)).astype(np.int32)
    q[0] = 255
    for s in range(8):
        qs = q >> s
        shift = np.full((1,), s, np.int32)
        got = tl.decode_1d(torch.from_numpy(qs), torch.from_numpy(shift), torch.from_numpy(a),
                           torch.from_numpy(b), 3).numpy()
        want = np.asarray(jl.decode_1d(jnp.asarray(qs), jnp.asarray(shift), jnp.asarray(a),
                                       jnp.asarray(b), 3))
        np.testing.assert_array_equal(got, want)
    dec = tl.decode_1d(torch.full((4, 1), 255, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32), torch.from_numpy(a),
                       torch.from_numpy(b), 3).numpy()
    assert abs(int(dec[0, 0, 0]) - 100) <= 1 and abs(int(dec[1, 0, 0]) - 239) <= 1
    # a wrap: a + (255 * -150 + 128 >> 8) < 0 reads back mod 256
    wrap = tl.decode_1d(torch.full((1, 1), 255, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), torch.tensor([[10]]),
                        torch.tensor([[250]]), 1).numpy()
    assert int(wrap[0, 0, 0]) == (10 + ((255 * 240 + 128) >> 8)) & 0xFF


@pytest.mark.parametrize("error_factor", [50, 800])
def test_fit_and_shift_search_equal_jax(error_factor):
    img = make_test_image(np.random.default_rng(0), 16, 16)
    jpx, jmask, _ = jlayout.blockify(jnp.asarray(img))
    px, mask, _ = layout.blockify(torch.from_numpy(img))
    jcfg = jl.LegacyConfig(error_factor=error_factor)
    cfg = tl.LegacyConfig(error_factor=error_factor)
    ja, jb, jfac, jacc, _ = jl.fit_2pt(jpx, jmask, jcfg)
    a, b, fac, acc, _ = tl.fit_2pt(px, mask, cfg)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(fac.numpy(), np.asarray(jfac), rtol=1e-5, atol=1e-5)
    f8 = torch.clamp(torch.round(fac * 255.0), 0, 255).to(torch.int32)
    jf8 = jnp.clip(jnp.rint(jfac * 255.0), 0, 255).astype(jnp.int32)
    shift = tl.find_shift_1d(px, mask, f8, a, b, cfg).numpy()
    np.testing.assert_array_equal(shift, np.asarray(jl.find_shift_1d(jpx, jmask, jf8, ja, jb,
                                                                     jcfg)))
    assert ((shift >= 0) & (shift <= 7)).all()


def test_encode_legacy_runs_with_dithering_and_four_levels():
    """Dithering draws from the port's hash (statistical parity only): the
    encode stays close to the undithered one; the shifts and coverage do not
    depend on it. More levels than JAX's default encode too."""
    img = _gradient(64, 96)
    on = tl.encode_legacy(img, tl.LegacyConfig(dithering=True), num_levels=4, device="cpu")
    off = tl.encode_legacy(img, tl.LegacyConfig(dithering=False), num_levels=4, device="cpu")
    np.testing.assert_array_equal(on["shift"], off["shift"])
    assert on["coverage"] == off["coverage"] == 100.0
    assert abs(on["psnr"] - off["psnr"]) < 1.5
