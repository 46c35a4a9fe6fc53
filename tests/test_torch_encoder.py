"""limg_tpu_torch.encode_image end to end vs the JAX package and golden (CPU).

On the CPU the port runs the kernel's plain version. Blocks whose rounded
endpoints agree with JAX (float sums differ in order; see
tests/test_torch_fit.py) must get the same shifts, crushed factors and
decoded pixels; image PSNR and mean bpp agree within 0.01.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu import golden
from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.encoder import encode_image as j_encode_image
from limg_tpu.encoder import encode_image_device as j_encode_image_device

import limg_tpu_torch
from limg_tpu_torch.config import EncodeConfig, config_from_jax
from limg_tpu_torch.encoder import encode_image_device, encode_perf_step
from limg_tpu_torch.kernels import build
from limg_tpu_torch.kernels import encode_fixed as kmod
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS
from tests.conftest import make_test_image

torch.set_num_threads(1)

IMAGES = {"40x56": (40, 56, 77), "37x61": (37, 61, 79), "128x192": (128, 192, 80)}


def _image(name, ch):
    h, w, seed = IMAGES[name]
    return make_test_image(np.random.default_rng(seed), h, w)[..., :ch]


@pytest.mark.parametrize("name,mode", [
    ("40x56", "ladder"), ("40x56", "exhaustive"), ("40x56", "guess"), ("40x56", "none"),
    ("37x61", "ladder"),
])
@pytest.mark.parametrize("channels", [3, 4])
def test_encode_image_matches_jax(name, mode, channels):
    img = _image(name, channels)
    jcfg = JConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode, dithering=False)
    cfg = config_from_jax(jcfg)
    _, jres = j_encode_image_device(jnp.asarray(img), jcfg, jax.random.PRNGKey(0))
    _, tres, _ = encode_image_device(img, cfg, 0, "cpu")

    agree = np.ones(tres.shifts.shape[1], bool)
    for f in ENDPOINT_FIELDS:
        agree &= (getattr(tres.decomposition, f).numpy()
                  == np.asarray(getattr(jres.decomposition, f))).all(axis=0)
    print(f"{name} ch={channels} {mode}: {(~agree).sum()} of {agree.size} blocks "
          f"with an endpoint flip")
    assert agree.mean() >= 0.99
    m = tres.mask.numpy()[None] | ~agree[None, None]     # compare real pixels only
    np.testing.assert_array_equal(tres.shifts.numpy()[:, agree], np.asarray(jres.shifts)[:, agree])
    for t, j in ((tres.factors, jres.factors), (tres.decoded, jres.decoded)):
        t, j = t.numpy()[..., agree], np.asarray(j)[..., agree]
        np.testing.assert_array_equal(np.where(m[..., agree], t, 0), np.where(m[..., agree], j, 0))

    tout = limg_tpu_torch.encode_image(img, cfg, device="cpu")
    jout = j_encode_image(img, jcfg, use_pallas=False)
    assert set(tout) == set(jout)
    for k in ("decoded", "factors_a", "shift", "bpp"):
        assert tout[k].shape == jout[k].shape and tout[k].dtype == jout[k].dtype, k
    assert abs(tout["psnr"] - jout["psnr"]) <= 0.01
    assert abs(tout["mean_bpp"] - jout["mean_bpp"]) <= 0.01
    assert abs(tout["avg_block_bits"] - jout["avg_block_bits"]) <= 0.01


@pytest.mark.parametrize("channels", [3, 4])
def test_dithered_encode_statistically_matches_jax(channels):
    """The port's counter-hash dither vs JAX's threefry: same quality."""
    img = _image("128x192", channels)
    jcfg = JConfig(error_factor=100, has_alpha=channels == 4, dithering=True)
    tout = limg_tpu_torch.encode_image(img, config_from_jax(jcfg), device="cpu")
    jout = j_encode_image(img, jcfg, use_pallas=False)
    print(f"ch={channels}: psnr {tout['psnr']:.4f} vs JAX {jout['psnr']:.4f}, "
          f"bpp {tout['mean_bpp']:.4f} vs {jout['mean_bpp']:.4f}")
    assert abs(tout["psnr"] - jout["psnr"]) <= 0.3
    assert abs(tout["mean_bpp"] - jout["mean_bpp"]) <= 0.1
    plain = limg_tpu_torch.encode_image(
        img, config_from_jax(JConfig(error_factor=100, has_alpha=channels == 4,
                                     dithering=False)), device="cpu")
    assert not np.array_equal(tout["decoded"], plain["decoded"])   # noise was added


def test_exhaustive_matches_golden():
    """Exhaustive crush vs the NumPy golden model's 729-triple search."""
    img = make_test_image(np.random.default_rng(77), 40, 56)
    jcfg = JConfig(error_factor=100, crush_mode="exhaustive", dithering=False)
    want = golden.encode_image_fixed_grid(img, jcfg)
    got = limg_tpu_torch.encode_image(img, config_from_jax(jcfg), device="cpu")
    np.testing.assert_array_equal(got["shift"], want["shift"])
    np.testing.assert_array_equal(got["decoded"], want["decoded"])
    assert abs(got["psnr"] - want["psnr"]) <= 0.01
    assert got["mean_bpp"] == want["mean_bpp"]


def test_wrapper_on_cpu_runs_plain_version():
    img = _image("37x61", 4)
    cfg = EncodeConfig(error_factor=100, has_alpha=True, dithering=True)
    packed, mask, _ = layout.blockify_packed(torch.from_numpy(img))
    before = kmod.launches
    got = kmod.encode_blocks_kernel(packed, mask, cfg, 3, emit_endpoints=True)
    want = kmod.encode_blocks_reference(packed, mask, cfg, 3, emit_endpoints=True)
    assert kmod.launches == before      # no kernel on the CPU
    assert len(got) == 11
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    shifts, q, dec, dist = got[:4]
    nb = packed.shape[1]
    assert shifts.shape == (3, nb) and q.shape == dec.shape == (64, nb) and dist.shape == (1, nb)
    assert dist.dtype == torch.float32 and torch.isfinite(dist).all()
    with pytest.raises(ValueError):
        kmod.encode_blocks_kernel(packed[:32], mask[:32], cfg, 0)
    with pytest.raises(ValueError):
        kmod.encode_blocks_kernel(packed.to(torch.int64), mask, cfg, 0)
    with pytest.raises(RuntimeError):
        kmod.encode_blocks_kernel(packed.to("meta"), mask.to("meta"), cfg, 0)


def test_perf_step_checksums():
    img = _image("40x56", 3)
    cfg = EncodeConfig(error_factor=100, dithering=False)
    dec_sum, shift_sum = encode_perf_step(img, cfg, 0, "cpu")
    _, res, _ = encode_image_device(img, cfg, 0, "cpu")
    assert int(shift_sum) == int(res.shifts.sum())
    packed, mask, _ = layout.blockify(torch.from_numpy(img))
    assert int(dec_sum) == int(kmod.encode_blocks_reference(
        layout.pack_channels(packed), mask, cfg, 0)[2].sum())


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    img = _image("40x56", 3)
    with pytest.raises(RuntimeError, match="cuda"):
        limg_tpu_torch.encode_image(img, EncodeConfig())      # device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        encode_perf_step(img, EncodeConfig(), 0, "cuda")


def test_missing_nvcc_raises(monkeypatch):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
