"""ctypes bindings for the native host runtime (runtime/limg_runtime.cpp).

The counterpart of ``limg_tpu/native.py``: the same entry points, the same
bytes. The C++ source is the port's own copy of the JAX package's
``runtime/limg_runtime.cpp`` (a test holds the two equal), built by g++ at
first use into ``build/runtime/`` at the root of the checkout, named by a
hash of the source, the flags and the host (``-march=native`` code runs
only where it was built), through a temporary file renamed into place, so
concurrent builds never load a half-written library. A failed build keeps
g++'s output in ``build_log`` and leaves ``available()`` False.

Every entry point has a NumPy fallback that gives the same bytes. Two
environment variables, read at every call and shared with the JAX
package, select them: ``LIMG_TPU_DISABLE_NATIVE`` (every entry point) and
``LIMG_TPU_DISABLE_NATIVE_FACTOR`` (the LTP1 factor-section functions,
``factor_kernels_available``). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "runtime" / "limg_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "runtime"
# tools/build_runtime.sh's flags (limg_tpu/native.py:41-44), and <string>
# included first: the source uses std::string without including it, which
# the libstdc++ of the H100 machine's g++ rejects
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-march=native", "-include", "string")
GXX_LIBS = ("-lpthread",)

_LIB = None
_TRIED = False
build_log = ""       # g++'s output of the last build attempt in this process


def library_path() -> Path:
    """Where the library of this source, these flags and this host lands."""
    digest = hashlib.sha256(" ".join((*GXX_FLAGS, *GXX_LIBS, platform.node())).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblimg_runtime_{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """Compile the runtime if its library is missing; None if g++ fails."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *GXX_LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = f"g++ did not run: {e}"
        return None
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.limg_rt_blockify_u32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.limg_rt_blockify_u32.restype = None
    lib.limg_rt_unblockify_u32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.limg_rt_unblockify_u32.restype = None
    for fn in (lib.limg_rt_write_tga_rgba, lib.limg_rt_write_tga_gray):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        fn.restype = ctypes.c_int
    lib.limg_rt_read_tga.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.limg_rt_read_tga.restype = ctypes.c_int
    lib.limg_rt_read_ppm.argtypes = lib.limg_rt_read_tga.argtypes
    lib.limg_rt_read_ppm.restype = ctypes.c_int
    lib.limg_rt_pool_new.argtypes = [ctypes.c_int]
    lib.limg_rt_pool_new.restype = ctypes.c_void_p
    lib.limg_rt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.limg_rt_pool_destroy.restype = None
    lib.limg_rt_pool_stage_file.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.limg_rt_pool_stage_file.restype = None
    lib.limg_rt_pool_await.argtypes = [ctypes.c_void_p]
    lib.limg_rt_pool_await.restype = None
    lib.limg_rt_max_threads.argtypes = []
    lib.limg_rt_max_threads.restype = ctypes.c_int64
    for fn in (lib.limg_rt_rans_encode, lib.limg_rt_rans_decode):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64]
    lib.limg_rt_rans_encode.restype = ctypes.c_int64
    lib.limg_rt_rans_decode.restype = ctypes.c_int
    lib.limg_rt_factor_extract.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.limg_rt_factor_extract.restype = None
    lib.limg_rt_factor_pack_axis.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_void_p] * 5)
    lib.limg_rt_factor_pack_axis.restype = ctypes.c_int64
    lib.limg_rt_factor_unpack_axis_syms.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p])
    lib.limg_rt_factor_unpack_axis_syms.restype = None
    lib.limg_rt_factor_unpack_axis_raw.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p])
    lib.limg_rt_factor_unpack_axis_raw.restype = None
    lib.limg_rt_decode_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p]
    lib.limg_rt_decode_blocks.restype = None
    lib.limg_rt_pack_headers.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.limg_rt_pack_headers.restype = None
    lib.limg_rt_unpack_headers.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.limg_rt_unpack_headers.restype = None
    return lib


def _lib():
    """The loaded library, or None: disabled, or its build failed."""
    global _LIB, _TRIED
    if os.environ.get("LIMG_TPU_DISABLE_NATIVE"):
        return None
    if not _TRIED:
        _TRIED = True
        path = _build()
        _LIB = None if path is None else _load(path)
    return _LIB


def available() -> bool:
    return _lib() is not None


def blockify_packed(image_rgba: np.ndarray):
    """(H, W, 4) uint8 -> ((64, NB) uint32 packed, (64, NB) uint8 mask),
    the layout of ``ops.layout.blockify_packed``."""
    h, w = image_rgba.shape[:2]
    by, bx = -(-h // 8), -(-w // 8)
    nb = by * bx
    img32 = np.ascontiguousarray(image_rgba).view(np.uint32).reshape(h, w)
    lib = _lib()
    if lib is not None:
        packed = np.empty((64, nb), np.uint32)
        mask = np.empty((64, nb), np.uint8)
        lib.limg_rt_blockify_u32(img32.ctypes.data, h, w, packed.ctypes.data, mask.ctypes.data)
        return packed, mask
    pad = np.zeros((by * 8, bx * 8), np.uint32)
    pad[:h, :w] = img32
    m = np.zeros((by * 8, bx * 8), np.uint8)
    m[:h, :w] = 1
    t = pad.reshape(by, 8, bx, 8).transpose(1, 3, 0, 2).reshape(64, nb)
    tm = m.reshape(by, 8, bx, 8).transpose(1, 3, 0, 2).reshape(64, nb)
    return t, tm


def unblockify_packed(packed: np.ndarray, h: int, w: int) -> np.ndarray:
    """(64, NB) uint32 -> (H, W, 4) uint8."""
    lib = _lib()
    if lib is not None:
        out = np.empty((h, w), np.uint32)
        packed = np.ascontiguousarray(packed, np.uint32)
        lib.limg_rt_unblockify_u32(packed.ctypes.data, h, w, out.ctypes.data)
    else:
        by, bx = -(-h // 8), -(-w // 8)
        t = packed.reshape(8, 8, by, bx).transpose(2, 0, 3, 1).reshape(by * 8, bx * 8)
        out = t[:h, :w].copy()
    return out.view(np.uint8).reshape(h, w, 4)


def write_tga(path: str, data: np.ndarray) -> None:
    """(H, W) grayscale or (H, W, 4) RGBA uint8 -> uncompressed TGA."""
    lib = _lib()
    if lib is None:
        from .io import write_tga as py_write

        py_write(path, data)
        return
    data = np.ascontiguousarray(data)
    h, w = data.shape[:2]
    if data.ndim == 2:
        rc = lib.limg_rt_write_tga_gray(path.encode(), data.ctypes.data, h, w)
    else:
        rgba = data.view(np.uint32).reshape(h, w)
        rc = lib.limg_rt_write_tga_rgba(path.encode(), rgba.ctypes.data, h, w)
    if rc != 0:
        raise IOError(f"tga write failed: {rc}")


def _read_tga_np(path: str) -> np.ndarray:
    """limg_rt_read_tga in NumPy: uncompressed truecolour (type 2, 24 or 32
    bits) or grayscale (type 3) TGA -> (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise IOError(f"tga read failed: {path}: short header")
    id_len, cmap, kind = data[0], data[1], data[2]
    w, h = int.from_bytes(data[12:14], "little"), int.from_bytes(data[14:16], "little")
    nbytes, desc = data[16] // 8, data[17]
    if cmap != 0 or kind not in (2, 3):
        raise IOError(f"tga read failed: {path}: type {kind}, colour map {cmap}")
    n = h * w * nbytes
    body = np.frombuffer(data, np.uint8, offset=18 + id_len)
    if body.size < n:
        raise IOError(f"tga read failed: {path}: truncated")
    px = body[:n].reshape(h, w, nbytes)
    if not desc & 0x20:
        px = px[::-1]
    out = np.full((h, w, 4), 0xFF, np.uint8)
    if kind == 3:
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., 2::-1]
        if nbytes == 4:
            out[..., 3] = px[..., 3]
    return out


def read_tga(path: str) -> np.ndarray:
    """Uncompressed TGA -> (H, W, 4) uint8 RGBA."""
    lib = _lib()
    if lib is None:
        return _read_tga_np(path)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.limg_rt_read_tga(path.encode(), None, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"tga probe failed: {rc}")
    out = np.empty((h.value, w.value), np.uint32)
    rc = lib.limg_rt_read_tga(path.encode(), out.ctypes.data, None, None)
    if rc != 0:
        raise IOError(f"tga read failed: {rc}")
    return out.view(np.uint8).reshape(h.value, w.value, 4)


# the status of a slot whose file's header gives another size than the
# slot's; the pool's readers would write the file's own height x width
# pixels into a buffer of the slot's size
STATUS_SIZE_MISMATCH = -11


class StagingPool:
    """Native worker pool that decodes and blockifies a corpus of same-size
    TGA / PPM images into preallocated slots, overlapping host IO with the
    device's encode (the JAX package's corpus staging, native.py:218).

    Each file's header is read before it is queued: a file of another size
    than the slot's is not staged, and its status is STATUS_SIZE_MISMATCH.
    """

    def __init__(self, threads: int | None = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native runtime not available; g++ said: {build_log}")
        self._lib = lib
        self.threads = int(threads or max(1, lib.limg_rt_max_threads()))
        self._pool = lib.limg_rt_pool_new(self.threads)
        self._keepalive = []

    def _probe(self, path: str):
        """(rc, h, w) from ``path``'s header by the reader its worker would
        run: rc 0, or the status the worker would give (-10: neither .tga
        nor .ppm)."""
        h, w = ctypes.c_int64(), ctypes.c_int64()
        if len(path) > 4 and path.endswith(".tga"):
            read = self._lib.limg_rt_read_tga
        elif len(path) > 4 and path.endswith(".ppm"):
            read = self._lib.limg_rt_read_ppm
        else:
            return -10, 0, 0
        return read(path.encode(), None, ctypes.byref(h), ctypes.byref(w)), h.value, w.value

    def stage(self, path: str, h: int, w: int):
        """Queue a file; returns (packed, mask, status) arrays filled
        asynchronously. status[0] becomes 1 on success, < 0 on error."""
        nb = -(-h // 8) * -(-w // 8)
        packed = np.empty((64, nb), np.uint32)
        mask = np.empty((64, nb), np.uint8)
        status = np.zeros(1, np.int32)
        rc, file_h, file_w = self._probe(path)
        if rc == 0 and (file_h, file_w) != (h, w):
            rc = STATUS_SIZE_MISMATCH
        if rc != 0:
            status[0] = rc
            return packed, mask, status
        # a worker writes a slot's status cell last: slots whose cell is set
        # are the caller's alone
        self._keepalive = [s for s in self._keepalive if s[2][0] == 0]
        self._keepalive.append((packed, mask, status))
        self._lib.limg_rt_pool_stage_file(self._pool, path.encode(), packed.ctypes.data,
                                          mask.ctypes.data, h, w, status.ctypes.data)
        return packed, mask, status

    def await_all(self):
        self._lib.limg_rt_pool_await(self._pool)

    def close(self):
        if self._pool:
            self._lib.limg_rt_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# rANS entropy codec of the LTP1 factor sections: 32-bit state, byte
# renormalisation, 12-bit probabilities. The NumPy fallback codes the same
# streams.
# ---------------------------------------------------------------------------

RANS_PROB_BITS = 12
RANS_PROB_SCALE = 1 << RANS_PROB_BITS
_RANS_LOW = 1 << 23


def rans_quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Histogram (256,) -> quantized freqs summing to RANS_PROB_SCALE,
    every occurring symbol >= 1."""
    counts = np.asarray(counts, np.int64)
    total = counts.sum()
    if total == 0:
        f = np.zeros(256, np.uint32)
        f[0] = RANS_PROB_SCALE
        return f
    f = np.maximum((counts * RANS_PROB_SCALE) // total, (counts > 0).astype(np.int64))
    # move the drift onto the largest symbols (each stays >= 1)
    drift = int(f.sum()) - RANS_PROB_SCALE
    order = np.argsort(-f)
    i = 0
    while drift != 0:
        j = order[i % 256]
        if drift > 0 and f[j] > 1:
            take = min(drift, int(f[j]) - 1)
            f[j] -= take
            drift -= take
        elif drift < 0 and f[j] > 0:
            f[j] += -drift
            drift = 0
        i += 1
    return f.astype(np.uint32)


def rans_encode(syms: np.ndarray, freqs: np.ndarray) -> bytes:
    syms = np.ascontiguousarray(syms, np.uint8)
    freqs = np.ascontiguousarray(freqs, np.uint32)
    n = syms.size
    lib = _lib()
    if lib is not None:
        out = np.empty(2 * n + 64, np.uint8)
        written = lib.limg_rt_rans_encode(syms.ctypes.data, n, freqs.ctypes.data,
                                          out.ctypes.data, out.size)
        if written < 0:
            raise ValueError(f"rans encode failed: {written}")
        return out[:written].tobytes()
    starts = np.zeros(257, np.uint32)
    starts[1:] = np.cumsum(freqs)
    if starts[256] != RANS_PROB_SCALE:
        raise ValueError("bad freqs")
    rev = bytearray()
    state = _RANS_LOW
    fl = freqs.tolist()
    stl = starts.tolist()
    for s in syms[::-1].tolist():
        f = fl[s]
        x_max = ((_RANS_LOW >> RANS_PROB_BITS) << 8) * f
        while state >= x_max:
            rev.append(state & 0xFF)
            state >>= 8
        state = ((state // f) << RANS_PROB_BITS) + (state % f) + stl[s]
    for _ in range(4):
        rev.append(state & 0xFF)
        state >>= 8
    return bytes(rev[::-1])


def rans_decode(data: bytes, freqs: np.ndarray, n: int) -> np.ndarray:
    freqs = np.ascontiguousarray(freqs, np.uint32)
    buf = np.frombuffer(data, np.uint8)
    lib = _lib()
    if lib is not None:
        out = np.empty(n, np.uint8)
        rc = lib.limg_rt_rans_decode(buf.ctypes.data, buf.size, freqs.ctypes.data,
                                     out.ctypes.data, n)
        if rc != 0:
            raise ValueError(f"rans decode failed: {rc}")
        return out
    starts = np.zeros(257, np.uint32)
    starts[1:] = np.cumsum(freqs)
    slot_sym = np.repeat(np.arange(256, dtype=np.uint8), freqs)
    out = np.empty(n, np.uint8)
    state = int.from_bytes(data[:4], "big")
    pos = 4
    fl = freqs.tolist()
    stl = starts.tolist()
    sl = slot_sym.tolist()
    for i in range(n):
        slot = state & (RANS_PROB_SCALE - 1)
        s = sl[slot]
        out[i] = s
        state = fl[s] * (state >> RANS_PROB_BITS) + slot - stl[s]
        while state < _RANS_LOW:
            if pos >= len(data):
                raise ValueError("rans stream truncated")
            state = (state << 8) | data[pos]
            pos += 1
    if state != _RANS_LOW:
        raise ValueError("rans stream corrupt")
    return out


# ---------------------------------------------------------------------------
# LTP1 factor-section functions (the serializer's hot path). All or nothing:
# the caller checks factor_kernels_available() once and otherwise runs its
# NumPy formulation, which writes the same bytes.
# ---------------------------------------------------------------------------

def factor_kernels_available() -> bool:
    if os.environ.get("LIMG_TPU_DISABLE_NATIVE_FACTOR"):
        return False
    return _lib() is not None


def factor_extract(q_words: np.ndarray) -> np.ndarray:
    """(64, NB) int32 packed factor words -> (3, NB, 64) uint8 axis planes."""
    q_words = np.ascontiguousarray(q_words, np.int32)
    nb = q_words.shape[1]
    out = np.empty((3, nb, 64), np.uint8)
    _lib().limg_rt_factor_extract(q_words.ctypes.data, nb, out.ctypes.data)
    return out


def factor_pack_axis(qk, maskb, ck, segk, wb, n_pix: int):
    """One axis's stream build in one native pass.

    Returns (vals, syms, hist, raw_blob, group_bytes): the gathered masked
    pixel values in stream order, the per-segment delta symbols
    (``bitstream._delta_seg``), their histogram, and the width-grouped raw
    packing with its byte count per width."""
    qk = np.ascontiguousarray(qk, np.uint8)
    maskb = np.ascontiguousarray(maskb, np.uint8)
    ck = np.ascontiguousarray(ck, np.int32)
    segk = np.ascontiguousarray(segk, np.int32)
    wb = np.ascontiguousarray(wb, np.uint8)
    vals = np.empty(n_pix, np.uint8)
    syms = np.empty(n_pix, np.uint8)
    hist = np.zeros(256, np.uint32)
    raw = np.empty(n_pix + 16, np.uint8)     # <= 8 bits a value, and slack
    group_bytes = np.zeros(9, np.int64)
    n = _lib().limg_rt_factor_pack_axis(
        qk.ctypes.data, maskb.ctypes.data, ck.ctypes.data, segk.ctypes.data, wb.ctypes.data,
        ck.size, vals.ctypes.data, syms.ctypes.data, hist.ctypes.data, raw.ctypes.data,
        group_bytes.ctypes.data)
    if n != n_pix:
        raise RuntimeError(f"factor_pack_axis: {n} != expected {n_pix}")
    return vals, syms, hist, raw[: int(group_bytes.sum())], group_bytes


def factor_unpack_axis_syms(syms, maskb, ck, segk, wb, qk_out: np.ndarray):
    """Undelta and scatter rANS-decoded symbols into the (NB, 64) plane."""
    syms = np.ascontiguousarray(syms, np.uint8)
    maskb = np.ascontiguousarray(maskb, np.uint8)
    ck = np.ascontiguousarray(ck, np.int32)
    segk = np.ascontiguousarray(segk, np.int32)
    wb = np.ascontiguousarray(wb, np.uint8)
    _lib().limg_rt_factor_unpack_axis_syms(
        syms.ctypes.data, maskb.ctypes.data, ck.ctypes.data, segk.ctypes.data, wb.ctypes.data,
        ck.size, qk_out.ctypes.data)


def factor_unpack_axis_raw(raw, group_bytes, maskb, ck, wb, qk_out: np.ndarray):
    """Unpack width-grouped raw factor bytes into the (NB, 64) plane."""
    raw = np.ascontiguousarray(raw, np.uint8)
    group_bytes = np.ascontiguousarray(group_bytes, np.int64)
    maskb = np.ascontiguousarray(maskb, np.uint8)
    ck = np.ascontiguousarray(ck, np.int32)
    wb = np.ascontiguousarray(wb, np.uint8)
    _lib().limg_rt_factor_unpack_axis_raw(
        raw.ctypes.data, group_bytes.ctypes.data, maskb.ctypes.data, ck.ctypes.data,
        wb.ctypes.data, ck.size, qk_out.ctypes.data)


def pack_headers(s_hdr, ep_hdr, ch: int) -> np.ndarray:
    """(3, nseg) shifts + (nseg, 6ch) endpoints -> (nseg, rec) header bytes
    (u16 shift word, then 12-bit biased endpoint fields, LSB first)."""
    s_hdr = np.ascontiguousarray(s_hdr, np.int32)
    ep_hdr = np.ascontiguousarray(ep_hdr, np.int32)
    nseg = s_hdr.shape[1]
    out = np.empty((nseg, 2 + 6 * ch * 12 // 8), np.uint8)
    _lib().limg_rt_pack_headers(s_hdr.ctypes.data, ep_hdr.ctypes.data, nseg, ch,
                                out.ctypes.data)
    return out


def unpack_headers(recs: np.ndarray, ch: int):
    """Inverse of pack_headers: (nseg, rec) bytes -> ((3, nseg) int32
    shifts, (nseg, 6ch) int32 endpoints)."""
    recs = np.ascontiguousarray(recs, np.uint8)
    nseg = recs.shape[0]
    s_hdr = np.empty((3, nseg), np.int32)
    ep_hdr = np.empty((nseg, 6 * ch), np.int32)
    _lib().limg_rt_unpack_headers(recs.ctypes.data, nseg, ch, s_hdr.ctypes.data,
                                  ep_hdr.ctypes.data)
    return s_hdr, ep_hdr


def decode_blocks_native(q3, shifts, eps, ch: int) -> np.ndarray:
    """(3, NB, 64) uint8 factors + per-block headers -> (64, NB) uint32 RGBA
    words (``unblockify_packed``'s layout)."""
    q3 = np.ascontiguousarray(q3, np.uint8)
    shifts = np.ascontiguousarray(shifts, np.int32)
    eps = np.ascontiguousarray(eps, np.int32)
    nb = q3.shape[1]
    out = np.empty((64, nb), np.uint32)
    _lib().limg_rt_decode_blocks(q3.ctypes.data, shifts.ctypes.data, eps.ctypes.data, nb, ch,
                                 out.ctypes.data)
    return out
