"""Run building and run coalescing: the four CUDA kernels' wrappers and plain
versions.

- ``match_pairs_kernel`` takes the role of the JAX package's
  ``match_pairs_pallas`` (limg_tpu/pallas_kernels/encode_merged.py:516): the
  27-probe merge test (ops/match.py ``match_decomps``) on paired (7ch, N)
  float32 row stacks in Decomposition field order (avg, dirA_min, dirA_max,
  dirB_offset, dirB_mag, dirC_offset, dirC_mag), a the candidate and b the
  reference. Returns (N,) bool.
- ``match_neighbors_kernel`` takes the role of ``match_neighbors_pallas``
  (:587): on a (7ch, by, bx) row plane, ``m_right[y, x]`` = match((y, x+1),
  (y, x)) and ``m_down[y, x]`` = match((y+1, x), (y, x)); the last column of
  m_right and the last row of m_down are False (callers drop them).
- ``seg_mixed_all_kernel`` takes the role of ``seg_mixed_all_pallas``
  (limg_tpu/pallas_kernels/seg_scan.py:140): the doubling-scan chain of
  ops/segments.py over (R, N) int32 or float32 rows.
- ``segment_encode_kernel`` takes the role of ``segment_encode_pallas``
  (limg_tpu/pallas_kernels/encode_segments.py:188): refit, factors, crush
  search, dither and decode of the contiguous segments (at most SEG_CAP
  members each) of the compacted run buffer, every per-segment value
  broadcast to its members. ``segment_encode_composed`` computes the same
  from plain ops, the JAX package's jnp branch of ``coalesce_segments``
  (limg_tpu/regions.py:737-772), with its segment scans and the crush
  search's candidate evaluations on the kernels of ``seg_mixed_all_kernel``
  and ``kernels/crush_eval.py``.

On a CUDA tensor each wrapper launches ``csrc/coalesce.cu`` (built at first
use) or raises; on a CPU tensor it runs the plain version. The two agree
bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import BLOCK_AREA, EncodeConfig
from ..ops.crush import find_shifts, force_dropped_axes
from ..ops.decode import decode_blocks
from ..ops.dither import dither_crush_key
from ..ops.error import weighted_error
from ..ops.factors import extract_factors, quantize_factors
from ..ops.fit import Decomposition, drop_decomposition_axes, fit_regions, tree_sum
from ..ops.layout import unpack_plane
from ..ops.match import match_decomps
from ..ops.reduce import SegmentReducer
from ..ops.segments import scan_steps, seg_mixed_all
from .encode_fixed import _CRUSH_MODES, _pack_decoded

# kernel launches since the last reset (read and reset by callers)
launches = {"match_neighbors": 0, "match_pairs": 0, "seg_mixed_all": 0, "segment_encode": 0}

# the most ladder verifications segment_encode_kernel keeps per block
MAX_LADDER_K = 16


class SegmentEncode(NamedTuple):
    shifts: torch.Tensor        # (3, N) i32
    q: torch.Tensor | None      # (64, N) i32 packed crushed factors
    dec: torch.Tensor           # (64, N) i32 packed decoded words
    dist_blk: torch.Tensor      # (N,) f32 weighted error of the block
    count_blk: torch.Tensor     # (N,) i32 member pixels of the block
    count_mem: torch.Tensor     # (N,) i32 pixels of the block's segment
    eps: torch.Tensor           # (6, ch, N) i32 endpoint rows
    avg: torch.Tensor           # (ch, N) f32


def _as_decomp(rows: torch.Tensor, ch: int) -> Decomposition:
    """(7ch, N) float32 stack -> Decomposition (endpoints are integers of
    int16 range, exact in float32)."""
    return Decomposition(rows[:ch], *(rows[ch * (1 + k):ch * (2 + k)].to(torch.int32)
                                      for k in range(6)))


def _device_route(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors the kernels take, False for CPU ones."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    return True


@functools.cache
def _library():
    """The built kernel library, with its C signatures declared."""
    from .build import load_library

    lib = load_library("coalesce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.limg_match_pairs.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
    lib.limg_match_neighbors.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr]
    lib.limg_seg_scan_i32.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr]
    lib.limg_seg_scan_f32.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float, i32, ptr, ptr]
    lib.limg_segment_encode.argtypes = ([ptr] * 4 + [i32] * 8 + [ctypes.c_uint32]
                                        + [ptr] * 10)
    for fn in (lib.limg_match_pairs, lib.limg_match_neighbors, lib.limg_seg_scan_i32,
               lib.limg_seg_scan_f32, lib.limg_segment_encode):
        fn.restype = i32
    lib.limg_cuda_error_string.argtypes = [i32]
    lib.limg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn_name: str, dev: torch.device, *args) -> None:
    """Call ``fn_name`` of the library on the current stream; raise on error."""
    lib = _library()
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.limg_cuda_error_string(rc).decode()} ({rc})")
    launches[name] += 1


def _check_rows(rows: torch.Tensor, ch: int, name: str) -> None:
    if rows.dtype != torch.float32 or rows.shape[0] != 7 * ch:
        raise ValueError(f"{name} must be (7*{ch}, ...) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")


# ---------------------------------------------------------------------------
# match_pairs / match_neighbors
# ---------------------------------------------------------------------------

def match_pairs_reference(rows_a: torch.Tensor, rows_b: torch.Tensor, channels: int):
    """Plain version of match_pairs_kernel."""
    return match_decomps(_as_decomp(rows_a, channels), _as_decomp(rows_b, channels),
                         channels)[0]


def match_pairs_kernel(rows_a: torch.Tensor, rows_b: torch.Tensor, channels: int):
    """(7ch, N) float32 stacks a, b -> (N,) bool; see the module docstring."""
    _check_rows(rows_a, channels, "rows_a")
    if rows_b.shape != rows_a.shape or rows_b.dtype != torch.float32:
        raise ValueError(f"rows_b must be {tuple(rows_a.shape)} float32")
    if not _device_route(rows_a, rows_b):
        return match_pairs_reference(rows_a, rows_b, channels)
    n = rows_a.shape[1]
    out = torch.empty((n,), dtype=torch.bool, device=rows_a.device)
    a, b = rows_a.contiguous(), rows_b.contiguous()
    _launch("match_pairs", "limg_match_pairs", a.device,
            a.data_ptr(), b.data_ptr(), n, channels, out.data_ptr())
    return out


def match_neighbors_reference(rows: torch.Tensor, channels: int):
    """Plain version of match_neighbors_kernel."""
    n, by, bx = rows.shape
    m_right = torch.zeros((by, bx), dtype=torch.bool, device=rows.device)
    m_down = torch.zeros((by, bx), dtype=torch.bool, device=rows.device)
    if bx > 1:
        m_right[:, :-1] = match_pairs_reference(
            rows[:, :, 1:].reshape(n, -1), rows[:, :, :-1].reshape(n, -1),
            channels).reshape(by, bx - 1)
    if by > 1:
        m_down[:-1] = match_pairs_reference(
            rows[:, 1:].reshape(n, -1), rows[:, :-1].reshape(n, -1),
            channels).reshape(by - 1, bx)
    return m_right, m_down


def match_neighbors_kernel(rows: torch.Tensor, channels: int):
    """(7ch, by, bx) float32 row plane -> (m_right, m_down) (by, bx) bool;
    see the module docstring."""
    _check_rows(rows, channels, "rows")
    if rows.ndim != 3:
        raise ValueError(f"rows must be (7ch, by, bx), got {tuple(rows.shape)}")
    if not _device_route(rows):
        return match_neighbors_reference(rows, channels)
    _, by, bx = rows.shape
    r = rows.contiguous()
    m_right = torch.empty((by, bx), dtype=torch.bool, device=r.device)
    m_down = torch.empty((by, bx), dtype=torch.bool, device=r.device)
    _launch("match_neighbors", "limg_match_neighbors", r.device,
            r.data_ptr(), by, bx, channels, m_right.data_ptr(), m_down.data_ptr())
    return m_right, m_down


# ---------------------------------------------------------------------------
# seg_mixed_all
# ---------------------------------------------------------------------------

def seg_mixed_all_reference(x: torch.Tensor, seg_c: torch.Tensor, n_sum: int, init_max=0):
    """Plain version of seg_mixed_all_kernel (ops/segments.py)."""
    return seg_mixed_all(x, seg_c, n_sum, init_max)


def seg_mixed_all_kernel(x: torch.Tensor, seg_c: torch.Tensor, n_sum: int, init_max=0):
    """(R, N) int32 or float32 rows, seg_c (N,) int32: rows [:n_sum] summed,
    the rest maxed, over contiguous segments; see ops/segments.py."""
    if x.ndim != 2 or x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"x must be (R, N) int32 or float32, got {tuple(x.shape)} {x.dtype}")
    if seg_c.shape != (x.shape[1],) or seg_c.dtype != torch.int32:
        raise ValueError(f"seg_c must be ({x.shape[1]},) int32, got "
                         f"{tuple(seg_c.shape)} {seg_c.dtype}")
    if not 0 <= n_sum <= x.shape[0]:
        raise ValueError(f"n_sum must be in [0, {x.shape[0]}], got {n_sum}")
    if not _device_route(x, seg_c):
        return seg_mixed_all_reference(x, seg_c, n_sum, init_max)
    r, n = x.shape
    xc, sc = x.contiguous(), seg_c.contiguous()
    out = torch.empty_like(xc)
    if r == 0 or n == 0:
        return out
    steps = len(scan_steps(n))
    if x.dtype == torch.int32:
        _launch("seg_mixed_all", "limg_seg_scan_i32", x.device, xc.data_ptr(), sc.data_ptr(),
                r, n, n_sum, int(init_max), steps, out.data_ptr())
    else:
        _launch("seg_mixed_all", "limg_seg_scan_f32", x.device, xc.data_ptr(), sc.data_ptr(),
                r, n, n_sum, float(init_max), steps, out.data_ptr())
    return out


def seg_sum_all(x: torch.Tensor, seg_c: torch.Tensor) -> torch.Tensor:
    """Per-member segment sums of the (N,) row ``x``, through the kernel."""
    return seg_mixed_all_kernel(x[None], seg_c, 1)[0]


def seg_min_all(x: torch.Tensor, seg_c: torch.Tensor, init=0) -> torch.Tensor:
    """Per-member segment minima of the (N,) row ``x``: -max(-x)."""
    return -seg_mixed_all_kernel(-x[None], seg_c, 0, -init)[0]


# ---------------------------------------------------------------------------
# segment_encode
# ---------------------------------------------------------------------------

def _check_segment_inputs(packed_c, mask_c, seg_c, blocks):
    if packed_c.ndim != 2 or packed_c.shape[0] != BLOCK_AREA or packed_c.dtype != torch.int32:
        raise ValueError(f"packed_c must be ({BLOCK_AREA}, N) int32, got "
                         f"{tuple(packed_c.shape)} {packed_c.dtype}")
    n = packed_c.shape[1]
    if mask_c.shape != packed_c.shape or mask_c.dtype != torch.bool:
        raise ValueError(f"mask_c must be {tuple(packed_c.shape)} bool, got "
                         f"{tuple(mask_c.shape)} {mask_c.dtype}")
    for name, t in (("seg_c", seg_c), ("blocks", blocks)):
        if t.shape != (n,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({n},) int32, got {tuple(t.shape)} {t.dtype}")


def _segment_encode(packed_c, mask_c, seg_c, blocks, cfg: EncodeConfig, key: int,
                    emit_q: bool, kernels: bool) -> SegmentEncode:
    """The fixed-grid encode's steps with every region reduction a segment
    scan (ops/reduce.py SegmentReducer); ``kernels`` routes the scans and
    the crush search's candidate evaluations through their kernels'
    wrappers, which take the plain versions on a CPU tensor."""
    _check_segment_inputs(packed_c, mask_c, seg_c, blocks)
    ch = cfg.channels
    px = torch.stack([unpack_plane(packed_c, c) for c in range(ch)])   # (ch, 64, N)
    red = SegmentReducer(seg_c, seg_mixed_all_kernel if kernels else seg_mixed_all)
    d, count = fit_regions(px, mask_c, ch, red)
    f8 = torch.stack([q.to(torch.int32) for q in quantize_factors(*extract_factors(px, d, ch))])
    d = drop_decomposition_axes(d, cfg.num_factors)
    shifts = force_dropped_axes(find_shifts(px, mask_c, f8, d, cfg, red, use_kernel=kernels)[0],
                                cfg.num_factors)
    q = dither_crush_key(f8, shifts, key, enabled=cfg.dithering and cfg.crush_bits,
                         blocks=blocks)
    dec = decode_blocks(q, shifts, d, ch)
    mask_i = mask_c.to(torch.int32)
    err = (weighted_error(dec, px) * mask_i).to(torch.float32)
    return SegmentEncode(
        shifts=shifts,
        q=q[0] | (q[1] << 8) | (q[2] << 16) if emit_q else None,
        dec=_pack_decoded(dec, ch),
        dist_blk=tree_sum(err, 0),
        count_blk=mask_i.sum(dim=0, dtype=torch.int32),
        count_mem=count,
        eps=torch.stack(list(d[1:])),
        avg=d.avg,
    )


def segment_encode_reference(packed_c: torch.Tensor, mask_c: torch.Tensor,
                             seg_c: torch.Tensor, blocks: torch.Tensor,
                             cfg: EncodeConfig, key: int, emit_q: bool = True) -> SegmentEncode:
    """Plain version of segment_encode_kernel, on any device."""
    return _segment_encode(packed_c, mask_c, seg_c, blocks, cfg, key, emit_q, kernels=False)


def segment_encode_composed(packed_c: torch.Tensor, mask_c: torch.Tensor,
                            seg_c: torch.Tensor, blocks: torch.Tensor,
                            cfg: EncodeConfig, key: int, emit_q: bool = True) -> SegmentEncode:
    """segment_encode_kernel's function as a composition of ops: the plain
    version's steps, with each segment scan through seg_mixed_all_kernel and
    each batch of crush candidates through crush_eval_rows_kernel
    (ops/crush.py find_shifts(use_kernel=True)). On a CUDA tensor it equals
    the segment kernel bit for bit; on a CPU tensor it is the plain
    version."""
    return _segment_encode(packed_c, mask_c, seg_c, blocks, cfg, key, emit_q, kernels=True)


def segment_encode_kernel(packed_c: torch.Tensor, mask_c: torch.Tensor,
                          seg_c: torch.Tensor, blocks: torch.Tensor,
                          cfg: EncodeConfig, key: int, emit_q: bool = True) -> SegmentEncode:
    """Re-encode of the contiguous segments of a compacted run buffer.

    ``packed_c`` (64, N) int32 words, ``mask_c`` (64, N) bool member pixels,
    ``seg_c`` (N,) int32 segment ids (the first member's position; members
    contiguous, at most SEG_CAP of them), ``blocks`` (N,) int32 the row-major
    image block index of each lane (the dither counter), ``key`` the 32-bit
    dither key. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel on the current stream or raises.
    """
    _check_segment_inputs(packed_c, mask_c, seg_c, blocks)
    if not _device_route(packed_c, mask_c, seg_c, blocks):
        return segment_encode_reference(packed_c, mask_c, seg_c, blocks, cfg, key, emit_q)
    if cfg.crush_mode == "ladder" and not 1 <= cfg.ladder_k <= MAX_LADDER_K:
        raise ValueError(f"segment_encode_kernel takes ladder_k 1-{MAX_LADDER_K}, "
                         f"got {cfg.ladder_k}")
    dev, ch, n = packed_c.device, cfg.channels, packed_c.shape[1]

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # block-major copies: one warp reads one block's 64 contiguous words
    packed_bm = packed_c.t().contiguous()
    mask_bm = mask_c.t().contiguous()
    f8_bm = empty(n, BLOCK_AREA)                       # the fit's factors, for the crush
    out = SegmentEncode(shifts=empty(3, n), q=empty(n, BLOCK_AREA) if emit_q else None,
                        dec=empty(n, BLOCK_AREA), dist_blk=empty(n, dtype=torch.float32),
                        count_blk=empty(n), count_mem=empty(n), eps=empty(6, ch, n),
                        avg=empty(ch, n, dtype=torch.float32))
    if n:
        _launch("segment_encode", "limg_segment_encode", dev,
                packed_bm.data_ptr(), mask_bm.data_ptr(), seg_c.contiguous().data_ptr(),
                blocks.contiguous().data_ptr(), n, ch,
                _CRUSH_MODES.get(cfg.crush_mode, 1) if cfg.crush_bits else 0,
                int(cfg.dithering and cfg.crush_bits), cfg.ladder_k, cfg.num_factors,
                cfg.max_pixel_bit_crush_error, cfg.max_block_bit_crush_error, key,
                f8_bm.data_ptr(), out.shifts.data_ptr(),
                None if out.q is None else out.q.data_ptr(), out.dec.data_ptr(),
                out.dist_blk.data_ptr(), out.count_blk.data_ptr(), out.count_mem.data_ptr(),
                out.eps.data_ptr(), out.avg.data_ptr())
    return out._replace(q=None if out.q is None else out.q.t(), dec=out.dec.t())
