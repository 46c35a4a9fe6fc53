"""limg_tpu_torch leaf ops and copied modules vs the JAX package (CPU).

Layout, error and decode are integer code and must match bit for bit;
config and io are copies and must behave identically. Inputs are made
with numpy from fixed seeds and passed to both packages.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limg_tpu.config as jcfg
import limg_tpu.io as jio
from limg_tpu import golden
from limg_tpu.ops import decode as jdecode
from limg_tpu.ops import error as jerror
from limg_tpu.ops import layout as jlayout
from limg_tpu.ops.fit import Decomposition as JDecomposition
from limg_tpu.pallas_kernels.encode_fixed import pack_channels as jpack_channels

import limg_tpu_torch.config as tcfg
import limg_tpu_torch.io as tio
from limg_tpu_torch.ops import decode as tdecode
from limg_tpu_torch.ops import dither as tdither
from limg_tpu_torch.ops import error as terror
from limg_tpu_torch.ops import layout as tlayout
from limg_tpu_torch.ops.fit import Decomposition as TDecomposition
from tests.conftest import make_test_image

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("h,w,ch", [(40, 56, 3), (40, 56, 4), (37, 61, 4), (64, 96, 3)])
def test_layout_matches_jax(h, w, ch):
    img = make_test_image(np.random.default_rng(h * 100 + w), h, w)[..., :ch]
    jpx, jmask, jgrid = jlayout.blockify(jnp.asarray(img))
    tpx, tmask, tgrid = tlayout.blockify(torch.from_numpy(img))
    assert tuple(tgrid) == tuple(jgrid)
    np.testing.assert_array_equal(_np(tpx), _np(jpx))
    np.testing.assert_array_equal(_np(tmask), _np(jmask))
    np.testing.assert_array_equal(_np(tlayout.unblockify(tpx, tgrid)), img)
    tpacked = tlayout.pack_channels(tpx)
    np.testing.assert_array_equal(_np(tpacked), _np(jpack_channels(jpx)))
    for c in range(ch):
        np.testing.assert_array_equal(_np(tlayout.unpack_plane(tpacked, c)), _np(tpx[c]))
    if ch == 4:
        kp, km, _ = tlayout.blockify_packed(torch.from_numpy(img))
        jp, jm, _ = jlayout.blockify_packed(jnp.asarray(img))
        np.testing.assert_array_equal(_np(kp), _np(jp))
        np.testing.assert_array_equal(_np(km), _np(jm))
    vals = np.random.default_rng(1).integers(0, 9, (3, tgrid.num_blocks)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tlayout.broadcast_block_plane(torch.from_numpy(vals), tgrid)),
        _np(jlayout.broadcast_block_plane(jnp.asarray(vals), jgrid)))


def test_weighted_error_and_psnr_match_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (4, 500)).astype(np.int32)
    b = rng.integers(0, 256, (4, 500)).astype(np.int32)
    for ch in (3, 4):
        got = _np(terror.weighted_error(torch.from_numpy(a[:ch]), torch.from_numpy(b[:ch])))
        np.testing.assert_array_equal(got, _np(jerror.weighted_error(jnp.asarray(a[:ch]), jnp.asarray(b[:ch]))))
        np.testing.assert_array_equal(got, golden.weighted_color_error(
            a[:ch].T.astype(np.uint8), b[:ch].T.astype(np.uint8), ch))
        assert terror.max_possible_error(ch) == jerror.max_possible_error(ch)
    img = make_test_image(rng, 40, 56)
    noisy = np.clip(img.astype(int) + rng.integers(-9, 10, img.shape), 0, 255).astype(np.uint8)
    for ch in (3, 4):
        p_t, mse_t = terror.psnr(torch.from_numpy(img), torch.from_numpy(noisy), ch)
        p_j, mse_j = jerror.psnr(jnp.asarray(img), jnp.asarray(noisy), ch)
        assert abs(p_t - float(p_j)) < 1e-4
        assert abs(mse_t - float(mse_j)) < 1e-3 * mse_t


@pytest.mark.parametrize("ch", [3, 4])
def test_decode_matches_jax_bitexact(ch):
    rng = np.random.default_rng(10 + ch)
    nb = 41
    eps = dict(
        dirA_min=rng.integers(-50, 100, (ch, nb)), dirA_max=rng.integers(100, 300, (ch, nb)),
        dirB_offset=rng.integers(-60, 0, (ch, nb)), dirB_mag=rng.integers(0, 60, (ch, nb)),
        dirC_offset=rng.integers(-30, 0, (ch, nb)), dirC_mag=rng.integers(0, 30, (ch, nb)),
    )
    eps = {k: v.astype(np.int32) for k, v in eps.items()}
    avg = np.zeros((ch, nb), np.float32)
    shifts = rng.integers(0, 9, (3, nb)).astype(np.int32)
    q = rng.integers(0, 256, (3, 64, nb)).astype(np.int32) >> np.minimum(shifts, 8)[:, None, :]
    jd = JDecomposition(avg=jnp.asarray(avg), **{k: jnp.asarray(v) for k, v in eps.items()})
    td = TDecomposition(avg=torch.from_numpy(avg), **{k: torch.from_numpy(v) for k, v in eps.items()})
    want = _np(jdecode.decode_blocks(jnp.asarray(q), jnp.asarray(shifts), jd, ch))
    got = _np(tdecode.decode_blocks(torch.from_numpy(q), torch.from_numpy(shifts), td, ch))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("error_factor", [0, 1, 50, 100, 333])
def test_config_copy_matches_jax(error_factor):
    props = ["channels", "crush_bits", "max_pixel_block_error", "max_block_pixel_error",
             "max_pixel_channel_block_error", "max_block_expand_error",
             "max_pixel_bit_crush_error", "max_block_bit_crush_error"]
    assert tcfg.BLOCK_SIZE == jcfg.BLOCK_SIZE and tcfg.BLOCK_AREA == jcfg.BLOCK_AREA
    for ch in (3, 4):
        assert tcfg.static_block_bits(ch) == jcfg.static_block_bits(ch)
    for has_alpha in (False, True):
        for mode in ("none", "guess", "ladder", "exhaustive"):
            j = jcfg.EncodeConfig(error_factor=error_factor, has_alpha=has_alpha, crush_mode=mode)
            t = tcfg.config_from_jax(j)
            assert [f.name for f in tcfg.dataclasses.fields(t)] == \
                [f.name for f in jcfg.dataclasses.fields(j)]
            for f in tcfg.dataclasses.fields(t):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
            for p in props:
                assert getattr(t, p) == getattr(j, p), p
            assert tcfg.config_from_jax(t) == t
    assert tcfg.EncodeConfig() == tcfg.config_from_jax(jcfg.EncodeConfig())


def test_io_copy_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (13, 21, 4), dtype=np.uint8)
    for mode, arr in (("RGBA", rgba), ("RGB", rgba[..., :3])):
        path = str(tmp_path / f"img_{mode}.png")
        Image.fromarray(arr, mode).save(path)
        t_img, t_alpha = tio.load_image(path)
        j_img, j_alpha = jio.load_image(path)
        assert t_alpha == j_alpha
        np.testing.assert_array_equal(t_img, j_img)
    for name, data in (("gray", rgba[..., 0]), ("rgba", rgba)):
        tio.write_tga(str(tmp_path / f"t_{name}.tga"), data)
        jio.write_tga(str(tmp_path / f"j_{name}.tga"), data)
        assert (tmp_path / f"t_{name}.tga").read_bytes() == (tmp_path / f"j_{name}.tga").read_bytes()


def test_dither_hash_properties():
    """Counter hash: deterministic, keyed, uniform low bits; noise range and
    the s=0 / s=8 exemptions of the reference's dither."""
    key = tdither.dither_key(0, 0xCA7F00D1)
    bits = tdither.dither_bits(key, 64, "cpu")
    assert bits.shape == (3, 64, 64) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
    assert torch.equal(bits, tdither.dither_bits(key, 64, "cpu"))
    assert not torch.equal(bits, tdither.dither_bits(tdither.dither_key(1, 0xCA7F00D1), 64, "cpu"))
    # a block's bits do not depend on how many blocks follow it
    assert torch.equal(bits[..., :10], tdither.dither_bits(key, 10, "cpu"))
    # fmix32 on int64 tensors equals the plain-integer form
    vals = [0, 1, 0xDEADBEEF, 2**32 - 1]
    assert [int(v) for v in tdither.fmix32(torch.tensor(vals))] == [tdither.fmix32(v) for v in vals]
    low = (bits & 0x7F).flatten().double()
    assert abs(float(low.mean()) - 63.5) < 3.0
    f8 = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 64, 64)).astype(np.int32))
    for s in range(9):
        shifts = torch.full((3, 64), s, dtype=torch.int32)
        q = tdither.dither_crush(f8, shifts, 0, 0xCA7F00D1)
        plain = f8 >> min(s, 8)
        if s in (0, 8):
            assert torch.equal(q, plain)
        else:
            assert int((q - plain).abs().max()) <= 1
            assert int(q.max()) <= 255 >> s
        assert torch.equal(tdither.dither_crush(f8, shifts, 0, 1, enabled=False), plain)


def test_import_pulls_in_no_jax():
    code = ("import sys, limg_tpu_torch, limg_tpu_torch.cli, limg_tpu_torch.io, "
            "limg_tpu_torch.kernels.encode_fixed, limg_tpu_torch.kernels.build, "
            "limg_tpu_torch.utils.timing, limg_tpu_torch.regions, "
            "limg_tpu_torch.kernels.encode_merged, limg_tpu_torch.ops.match, "
            "limg_tpu_torch.ops.morton, limg_tpu_torch.ops.reduce, "
            "limg_tpu_torch.kernels.coalesce, limg_tpu_torch.ops.segments, "
            "limg_tpu_torch.kernels.seg_fold, limg_tpu_torch.kernels.crush_eval, "
            "limg_tpu_torch.bitstream, limg_tpu_torch.native, limg_tpu_torch.utils.diagnostics, "
            "limg_tpu_torch.parallel, limg_tpu_torch.parallel.mesh, limg_tpu_torch.parallel.corpus; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'limg_tpu.')) "
            "or m in ('limg_tpu', 'PIL', 'triton')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_busy_ms_has_no_device_trace_on_the_cpu():
    """device_busy_ms (limg_tpu/utils/timing.py:108) returns None where no
    device trace exists, as JAX's does; on the CPU the call is not profiled."""
    from limg_tpu_torch.utils import timing

    calls = []
    assert timing.device_busy_ms(lambda: calls.append(1), device="cpu") is None
    assert timing.device_busy_ms(lambda: calls.append(1), 5, device=torch.device("cpu")) is None
    assert timing.profile_device(lambda: calls.append(1), device="cpu") is None
    assert calls == []
    prof = timing.DeviceProfile({"k1": 2.5, "k2": 0.5}, {}, 10.0)
    assert prof.busy_us == 3.0
