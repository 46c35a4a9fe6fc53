"""limg_tpu_torch.native against limg_tpu.native (CPU): the port's copy of
the host runtime gives the JAX binding's outputs from the same seeded
inputs (tests/test_native.py), its NumPy fallbacks give the native path's,
and its library is built from its own copy of runtime/limg_runtime.cpp
under a hashed name."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from limg_tpu import bitstream as jb
from limg_tpu import native as jn
from limg_tpu_torch import bitstream as tb
from limg_tpu_torch import native as tn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(21).integers(0, 256, (37, 53, 4), dtype=np.uint8)


@pytest.fixture()
def numpy_fallback(monkeypatch):
    """Every port entry point on its NumPy fallback."""
    monkeypatch.setenv("LIMG_TPU_DISABLE_NATIVE", "1")
    assert not tn.available() and not tn.factor_kernels_available()


def test_runtime_source_is_the_jax_packages():
    with open(os.path.join(REPO, "runtime", "limg_runtime.cpp"), "rb") as f:
        want = f.read()
    assert tn.SOURCE.read_bytes() == want


def test_library_is_built_under_a_hashed_name():
    assert tn.available() and tn.factor_kernels_available()
    path = tn.library_path()
    assert path.parent == tn.BUILD_DIR
    assert tn.BUILD_DIR == tn.Path(REPO) / "build" / "runtime"
    assert re.fullmatch(r"liblimg_runtime_[0-9a-f]{16}\.so", path.name)
    assert path.exists()
    # this process's temporary file was renamed into place (other test
    # processes may be building concurrently)
    assert not list(tn.BUILD_DIR.glob(f"*.{os.getpid()}.tmp"))


def test_failed_build_reports_unavailable(tmp_path, monkeypatch):
    bad = tmp_path / "limg_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "_TRIED", False)
    monkeypatch.setattr(tn, "_LIB", None)
    monkeypatch.setattr(tn, "build_log", "")
    assert not tn.available() and not tn.factor_kernels_available()
    assert "error" in tn.build_log
    assert not list((tmp_path / "build").glob("*"))
    with pytest.raises(RuntimeError, match="not available"):
        tn.StagingPool(1)


def test_blockify_equals_jax(img):
    packed, mask = tn.blockify_packed(img)
    want_p, want_m = jn.blockify_packed(img)
    np.testing.assert_array_equal(packed, want_p)
    np.testing.assert_array_equal(mask, want_m)
    np.testing.assert_array_equal(tn.unblockify_packed(packed, *img.shape[:2]), img)


def test_blockify_fallback_equals_native(img, monkeypatch):
    packed, mask = tn.blockify_packed(img)
    back = tn.unblockify_packed(packed, *img.shape[:2])
    monkeypatch.setenv("LIMG_TPU_DISABLE_NATIVE", "1")
    fp, fm = tn.blockify_packed(img)
    np.testing.assert_array_equal(fp, packed)
    np.testing.assert_array_equal(fm, mask)
    np.testing.assert_array_equal(tn.unblockify_packed(fp, *img.shape[:2]), back)


def test_tga_equals_jax_and_fallback(tmp_path, img, monkeypatch):
    gray = np.ascontiguousarray(img[..., 1])
    for name, data in (("rgba", img), ("gray", gray)):
        tn.write_tga(str(tmp_path / f"t_{name}.tga"), data)
        jn.write_tga(str(tmp_path / f"j_{name}.tga"), data)
        assert (tmp_path / f"t_{name}.tga").read_bytes() == \
            (tmp_path / f"j_{name}.tga").read_bytes()
    native_rgba = tn.read_tga(str(tmp_path / "t_rgba.tga"))
    native_gray = tn.read_tga(str(tmp_path / "t_gray.tga"))
    np.testing.assert_array_equal(native_rgba, img)
    np.testing.assert_array_equal(native_rgba, jn.read_tga(str(tmp_path / "t_rgba.tga")))
    monkeypatch.setenv("LIMG_TPU_DISABLE_NATIVE", "1")
    tn.write_tga(str(tmp_path / "f_rgba.tga"), img)
    assert (tmp_path / "f_rgba.tga").read_bytes() == (tmp_path / "t_rgba.tga").read_bytes()
    np.testing.assert_array_equal(tn.read_tga(str(tmp_path / "t_rgba.tga")), native_rgba)
    np.testing.assert_array_equal(tn.read_tga(str(tmp_path / "t_gray.tga")), native_gray)


def test_staging_pool(tmp_path, img):
    path = str(tmp_path / "s.tga")
    tn.write_tga(path, img)
    pool = tn.StagingPool(2)
    try:
        want_p, want_m = tn.blockify_packed(img)
        slots = [pool.stage(path, *img.shape[:2]) for _ in range(4)]
        pool.await_all()
        for packed, mask, status in slots:
            assert status[0] == 1
            np.testing.assert_array_equal(packed, want_p)
            np.testing.assert_array_equal(mask, want_m)
    finally:
        pool.close()


def test_rans_equals_jax_and_fallback(monkeypatch):
    rng = np.random.default_rng(0)
    syms = np.minimum(rng.geometric(0.3, 5000) - 1, 255).astype(np.uint8)
    hist = np.bincount(syms, minlength=256)
    freqs = tn.rans_quantize_freqs(hist)
    np.testing.assert_array_equal(freqs, jn.rans_quantize_freqs(hist))
    assert freqs.sum() == tn.RANS_PROB_SCALE
    np.testing.assert_array_equal(tn.rans_quantize_freqs(np.zeros(256)),
                                  jn.rans_quantize_freqs(np.zeros(256)))
    blob = tn.rans_encode(syms, freqs)
    assert blob == jn.rans_encode(syms, freqs)
    assert len(blob) * 8 < 4 * syms.size
    np.testing.assert_array_equal(tn.rans_decode(blob, freqs, syms.size), syms)
    monkeypatch.setenv("LIMG_TPU_DISABLE_NATIVE", "1")
    assert tn.rans_encode(syms, freqs) == blob
    np.testing.assert_array_equal(tn.rans_decode(blob, freqs, syms.size), syms)
    with pytest.raises(ValueError):
        tn.rans_decode(blob[:-8], freqs, syms.size)


@pytest.mark.parametrize("ch", [3, 4])
def test_header_records_equal_jax(rng, ch):
    nseg = 311
    s_hdr = rng.integers(0, 9, (3, nseg)).astype(np.int32)
    ep_hdr = rng.integers(-2048, 2047, (nseg, 6 * ch)).astype(np.int32)
    recs = tn.pack_headers(s_hdr, ep_hdr, ch)
    np.testing.assert_array_equal(recs, jn.pack_headers(s_hdr, ep_hdr, ch))
    # the serializer's NumPy formulation (limg_tpu/bitstream.py:249-258)
    swords = (s_hdr[0] | (s_hdr[1] << 4) | (s_hdr[2] << 8)).astype("<u2")
    bits = ((ep_hdr + 2048).astype(np.uint32)[:, :, None] >> np.arange(12)) & 1
    ep_bytes = np.packbits(bits.astype(np.uint8).reshape(nseg, -1), axis=1, bitorder="little")
    np.testing.assert_array_equal(
        recs, np.concatenate([swords.view(np.uint8).reshape(nseg, 2), ep_bytes], axis=1))
    s2, ep2 = tn.unpack_headers(recs, ch)
    np.testing.assert_array_equal(s2, s_hdr)
    np.testing.assert_array_equal(ep2, ep_hdr)


def test_factor_sections_equal_jax_and_numpy(rng):
    """The C++ factor-section functions give the JAX binding's outputs and
    the serializer's NumPy formulation (gather order, delta transform,
    width-group raw packing, scatter)."""
    for _ in range(3):
        nb = int(rng.integers(5, 700))
        n_sel = int(rng.integers(1, nb + 1))
        ck = np.sort(rng.choice(nb, n_sel, replace=False)).astype(np.int32)
        segk = np.cumsum(rng.random(n_sel) < 0.3).astype(np.int32)
        wb = rng.integers(1, 9, n_sel).astype(np.uint8)
        maskb = (rng.random((nb, 64)) < 0.97).astype(np.uint8)
        qk = rng.integers(0, 256, (nb, 64), dtype=np.uint8)
        for i in range(n_sel):
            qk[ck[i]] &= np.uint8((1 << int(wb[i])) - 1)
        mm = maskb[ck].astype(bool)
        vals_np = qk[ck][mm]
        n_pix = int(vals_np.size)
        wv = np.broadcast_to(wb[:, None], (n_sel, 64))[mm]
        sv = np.broadcast_to(segk[:, None], (n_sel, 64))[mm]
        syms_np = tb._delta_seg(vals_np, sv, wv.astype(np.int16))
        np.testing.assert_array_equal(syms_np, jb._delta_seg(vals_np, sv, wv.astype(np.int16)))

        got = tn.factor_pack_axis(qk, maskb, ck, segk, wb, n_pix)
        want = jn.factor_pack_axis(qk, maskb, ck, segk, wb, n_pix)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        vals_c, syms_c, hist_c, raw_c, gb_c = got
        np.testing.assert_array_equal(vals_c, vals_np)
        np.testing.assert_array_equal(syms_c, syms_np)
        np.testing.assert_array_equal(hist_c, np.bincount(syms_np, minlength=256))
        raw_np = np.concatenate([tb._pack_bits(vals_np[wv == v], v) for v in range(1, 9)])
        np.testing.assert_array_equal(raw_c, raw_np)

        scattered = np.zeros((nb, 64), np.uint8)
        scattered[np.repeat(ck, mm.sum(axis=1)),
                  np.concatenate([np.flatnonzero(m) for m in mm])] = vals_np
        out_s = np.zeros((nb, 64), np.uint8)
        tn.factor_unpack_axis_syms(syms_c, maskb, ck, segk, wb, out_s)
        np.testing.assert_array_equal(out_s, scattered)
        out_r = np.zeros((nb, 64), np.uint8)
        tn.factor_unpack_axis_raw(raw_c, gb_c, maskb, ck, wb, out_r)
        np.testing.assert_array_equal(out_r, scattered)


def test_factor_extract_equals_jax(rng):
    words = rng.integers(0, 2**24, (64, 301)).astype(np.int32)
    got = tn.factor_extract(words)
    np.testing.assert_array_equal(got, jn.factor_extract(words))
    for k in range(3):
        np.testing.assert_array_equal(got[k], ((words >> (8 * k)) & 0xFF).T)


@pytest.mark.parametrize("ch", [3, 4])
def test_decode_blocks_equals_jax_and_numpy(rng, ch):
    nb = 257
    q3 = rng.integers(0, 256, (3, nb, 64), dtype=np.uint8)
    shifts = rng.integers(0, 9, (3, nb)).astype(np.int32)
    eps = rng.integers(-300, 500, (6 * ch, nb)).astype(np.int32)
    words = tn.decode_blocks_native(q3, shifts, eps, ch)
    np.testing.assert_array_equal(words, jn.decode_blocks_native(q3, shifts, eps, ch))
    ref = tb._decode_blocks_np(q3.astype(np.int32), shifts, eps, ch)
    np.testing.assert_array_equal(ref, jb._decode_blocks_np(q3.astype(np.int32), shifts, eps, ch))
    got = np.stack([((words >> (8 * c)) & 0xFF).astype(np.uint8).T for c in range(ch)])
    np.testing.assert_array_equal(got, ref)
    if ch == 3:
        assert ((words >> 24) == 0xFF).all()


def test_numpy_fallback_runs_without_the_library(numpy_fallback, img, tmp_path):
    """With LIMG_TPU_DISABLE_NATIVE no entry point loads the library."""
    packed, mask = tn.blockify_packed(img)
    np.testing.assert_array_equal(packed, jn.blockify_packed(img)[0])
    with pytest.raises(RuntimeError):
        tn.StagingPool(1)


def test_import_builds_nothing(tmp_path):
    """Importing the module runs no compiler and touches no build directory."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import limg_tpu_torch.native as n; "
            "print(n._TRIED, n._LIB)")
    proc = subprocess.run([sys.executable, "-c", code, REPO], capture_output=True, text=True,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "None"]
