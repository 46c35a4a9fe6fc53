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
- ``seg_scan`` takes the role of ``seg_mixed_all_pallas``
  (limg_tpu/pallas_kernels/seg_scan.py:140): the doubling-scan chain of
  ops/segments.py for a batch of independent problems (``ScanProblem``:
  each its own segment map and int32 or float32 rows of sum, max or min)
  in one launch; ``seg_mixed_all_kernel`` is a one-problem call of it
  (of (R, N) rows), which ops/segments.py's ``seg_sum_all`` /
  ``seg_max_all`` / ``seg_min_all`` take on a card.
- ``segment_encode_kernel`` takes the role of ``segment_encode_pallas``
  (limg_tpu/pallas_kernels/encode_segments.py:188): refit, factors, crush
  search, dither and decode of the contiguous segments (at most SEG_CAP
  members each) of the compacted run buffer, every per-segment value
  broadcast to its members. A lane of the buffer is a region of P = 64
  (an 8x8 block) or P = 64 * 4^l pixels (the dense path's level l >= 1),
  the error of a region of 2048 pixels or more pre-scaled as in
  ``ops/crush.py err_scale_shift``. ``segment_encode_composed`` computes the same
  from plain ops, the JAX package's jnp branch of ``coalesce_segments``
  (limg_tpu/regions.py:737-772), with its segment scans and the crush
  search's candidate evaluations on the kernels of ``seg_mixed_all_kernel``
  and ``kernels/crush_eval.py``.

On a CUDA tensor each wrapper launches ``csrc/coalesce.cu`` (the segment
encode at P > 64: ``csrc/segment_region.cu``, from P = 1024 on a
thread-block cluster a segment; each built at first use) or raises; on a
CPU tensor it runs the plain version. The two agree bit for bit on the
card.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Sequence

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
from . import launch
from .encode_fixed import region_level

# the C entries: csrc/coalesce.cu's four kernels (the segment encode at
# P = 64) and csrc/segment_region.cu's segment encode at every P > 64

# the most ladder verifications segment_encode_kernel keeps per block
MAX_LADDER_K = 16
# one seg_scan launch takes at most this many problems of at most this many
# rows (csrc/coalesce.cu kScanMaxProblems, kScanMaxRows); larger batches
# take more launches
SCAN_MAX_PROBLEMS = 16
SCAN_MAX_ROWS = 4
_SCAN_OPS = {"s": 0, "x": 1, "n": 2}   # sum, max, min (-max(-x))


class ScanProblem(NamedTuple):
    """One problem of a batched segment scan (``seg_scan``).

    ``seg``: int32 segment ids, (N,), or a (gy, gx) map with ``columns``.
    ``rows``: the rows to reduce, each of ``seg``'s shape, all int32 or all
    float32; None is a row of int32 ones (a run length). ``ops``: one
    letter per row, "s" sum, "x" max, "n" min. ``init``: the value of the
    lanes outside the problem in a max or min row (ops/segments.py's
    shifted-in fill; a guard on a real id never takes it). ``columns``:
    scan the (gy, gx) map column by column, lane i at element (i % gy,
    i // gy), and give the results in the map's own layout.
    """

    seg: torch.Tensor
    rows: Sequence[torch.Tensor | None]
    ops: str
    init: int | float = 0
    columns: bool = False


class _ScanRow(ctypes.Structure):        # csrc/coalesce.cu ScanRow
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p), ("op", ctypes.c_int),
                ("fill", ctypes.c_int)]


class _ScanProblem(ctypes.Structure):    # csrc/coalesce.cu ScanProblem
    _fields_ = [("seg", ctypes.c_void_p), ("n", ctypes.c_int), ("gy", ctypes.c_int),
                ("steps", ctypes.c_int), ("is_float", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("rows", _ScanRow * SCAN_MAX_ROWS)]


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


def _on_card(*tensors: torch.Tensor) -> bool:
    """``launch.on_card`` of tensors that must share one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return launch.on_card(dev)


def _launch(kernel: str, fn_name: str, dev: torch.device, *args,
            library: str = "coalesce") -> None:
    launch.call(launch.library(library), fn_name, kernel, dev, *args)


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
    if not _on_card(rows_a, rows_b):
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
    if not _on_card(rows):
        return match_neighbors_reference(rows, channels)
    _, by, bx = rows.shape
    r = rows.contiguous()
    m_right = torch.empty((by, bx), dtype=torch.bool, device=r.device)
    m_down = torch.empty((by, bx), dtype=torch.bool, device=r.device)
    _launch("match_neighbors", "limg_match_neighbors", r.device,
            r.data_ptr(), by, bx, channels, m_right.data_ptr(), m_down.data_ptr())
    return m_right, m_down


# ---------------------------------------------------------------------------
# seg_scan (seg_mixed_all)
# ---------------------------------------------------------------------------

def _check_scan_problem(p: ScanProblem) -> torch.dtype:
    """Raise on a malformed problem; the dtype of its rows."""
    if p.seg.dtype != torch.int32 or p.seg.ndim != (2 if p.columns else 1):
        raise ValueError(f"seg must be {'(gy, gx)' if p.columns else '(N,)'} int32, got "
                         f"{tuple(p.seg.shape)} {p.seg.dtype}")
    if len(p.ops) != len(p.rows) or not p.rows or set(p.ops) - set(_SCAN_OPS):
        raise ValueError(f"ops must give one of 's', 'x', 'n' per row, got {p.ops!r} for "
                         f"{len(p.rows)} rows")
    dtypes = {torch.int32 if r is None else r.dtype for r in p.rows}
    if len(dtypes) != 1 or not dtypes <= {torch.int32, torch.float32}:
        raise ValueError(f"the rows of a problem must be all int32 or all float32, got {dtypes}")
    for r in p.rows:
        if r is not None and r.shape != p.seg.shape:
            raise ValueError(f"row {tuple(r.shape)} must have seg's shape {tuple(p.seg.shape)}")
    return dtypes.pop()


def _lanes(t: torch.Tensor, columns: bool) -> torch.Tensor:
    """A problem's tensor in lane order."""
    return t.t().reshape(-1) if columns else t


def _fill_value(init, op: str, dtype: torch.dtype):
    """The value of a row's lanes outside the problem as they are scanned:
    0 for a sum, ``init`` for a max, ``-init`` for a min (int32 wrapping)."""
    v = 0 if op == "s" else (-init if op == "n" else init)
    return float(v) if dtype == torch.float32 else (int(v) + 2**31) % 2**32 - 2**31


def _fill_bits(init, op: str, dtype: torch.dtype) -> int:
    """_fill_value's 32-bit pattern."""
    v = _fill_value(init, op, dtype)
    return struct.unpack("<i", struct.pack("<f", v))[0] if dtype == torch.float32 else v


def seg_scan_reference(problems: Sequence[ScanProblem]) -> list[torch.Tensor]:
    """Plain version of seg_scan: each row one ops/segments.py seg_mixed_all
    chain (min rows as -max(-x)), which is what one call on the whole
    problem gives each of its rows."""
    outs = []
    for p in problems:
        dtype = _check_scan_problem(p)
        seg = _lanes(p.seg, p.columns)
        res = []
        for row, op in zip(p.rows, p.ops):
            x = (torch.ones(seg.shape, dtype=torch.int32, device=seg.device) if row is None
                 else _lanes(row, p.columns))[None]
            if op == "n":
                y = -seg_mixed_all(-x, seg, 0, _fill_value(p.init, op, dtype))[0]
            else:
                y = seg_mixed_all(x, seg, int(op == "s"), p.init)[0]
            res.append(y.reshape(p.seg.shape[::-1]).t() if p.columns else y)
        outs.append(torch.stack(res))
    return outs


def seg_scan(problems: Sequence[ScanProblem]) -> list[torch.Tensor]:
    """The doubling-scan chain of ops/segments.py for independent problems:
    per problem an (R, *seg.shape) tensor, row i the segment sums, maxima or
    minima (``ops[i]``) of row i, each lane holding its segment's total.

    Bit-equal to one plain ``seg_mixed_all`` call per problem, step count
    (``scan_steps(N)``), outside fills (id -1 left and -2 right) and the
    float sum's ``fwd + bwd - x`` included, for any ids: every CTA scans one
    row over one tile of one problem, its lanes outside the problem
    carrying those fills, and compares ids as the plain version does. A CPU
    tensor goes to the plain version; CUDA tensors take one launch for up to
    SCAN_MAX_PROBLEMS problems of up to SCAN_MAX_ROWS rows (a problem with
    more rows counts as several) or raise.
    """
    dtypes = [_check_scan_problem(p) for p in problems]
    tensors = [t for p in problems for t in (p.seg, *p.rows) if t is not None]
    if not tensors or not _on_card(*tensors):
        return seg_scan_reference(problems)
    dev = tensors[0].device
    outs, descs, keep = [], [], []
    for p, dtype in zip(problems, dtypes):
        seg = p.seg.contiguous()
        out = torch.empty((len(p.rows), *seg.shape), dtype=dtype, device=dev)
        outs.append(out)
        n = seg.numel()
        if n == 0:
            continue
        rows = [None if r is None else r.contiguous() for r in p.rows]
        keep += [seg, *rows]
        for k in range(0, len(rows), SCAN_MAX_ROWS):
            d = _ScanProblem(seg=seg.data_ptr(), n=n, gy=seg.shape[0] if p.columns else 0,
                             steps=len(scan_steps(n)), is_float=int(dtype == torch.float32),
                             n_rows=len(rows[k:k + SCAN_MAX_ROWS]))
            for i, (r, op) in enumerate(zip(rows[k:k + SCAN_MAX_ROWS], p.ops[k:])):
                d.rows[i] = _ScanRow(x=None if r is None else r.data_ptr(),
                                     out=out[k + i].data_ptr(), op=_SCAN_OPS[op],
                                     fill=_fill_bits(p.init, op, dtype))
            descs.append(d)
    for k in range(0, len(descs), SCAN_MAX_PROBLEMS):
        batch = descs[k:k + SCAN_MAX_PROBLEMS]
        array = (_ScanProblem * len(batch))(*batch)
        _launch("seg_mixed_all", "limg_seg_scan", dev, ctypes.addressof(array), len(batch))
    del keep   # alive until the launches: the allocator may reuse a freed block at once
    return outs


def seg_mixed_all_reference(x: torch.Tensor, seg_c: torch.Tensor, n_sum: int, init_max=0):
    """Plain version of seg_mixed_all_kernel (ops/segments.py)."""
    return seg_mixed_all(x, seg_c, n_sum, init_max)


def seg_mixed_all_kernel(x: torch.Tensor, seg_c: torch.Tensor, n_sum: int, init_max=0):
    """(R, N) int32 or float32 rows, seg_c (N,) int32: rows [:n_sum] summed,
    the rest maxed, over contiguous segments; see ops/segments.py. One
    seg_scan problem."""
    if x.ndim != 2 or x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"x must be (R, N) int32 or float32, got {tuple(x.shape)} {x.dtype}")
    if seg_c.shape != (x.shape[1],) or seg_c.dtype != torch.int32:
        raise ValueError(f"seg_c must be ({x.shape[1]},) int32, got "
                         f"{tuple(seg_c.shape)} {seg_c.dtype}")
    if not 0 <= n_sum <= x.shape[0]:
        raise ValueError(f"n_sum must be in [0, {x.shape[0]}], got {n_sum}")
    if not _on_card(x, seg_c):
        return seg_mixed_all_reference(x, seg_c, n_sum, init_max)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    ops = "s" * n_sum + "x" * (x.shape[0] - n_sum)
    return seg_scan([ScanProblem(seg_c, list(x.contiguous()), ops, init_max)])[0]


# ---------------------------------------------------------------------------
# segment_encode
# ---------------------------------------------------------------------------

def _check_segment_inputs(packed_c, mask_c, seg_c, blocks):
    if packed_c.ndim != 2 or packed_c.dtype != torch.int32:
        raise ValueError(f"packed_c must be (P, N) int32 with P = 64 * 4^l, got "
                         f"{tuple(packed_c.shape)} {packed_c.dtype}")
    region_level(packed_c.shape[0])
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
        dec=launch.pack_decoded(dec, ch),
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

    ``packed_c`` (P, N) int32 words of N regions of P = 64 * 4^l pixels, ``mask_c`` (P, N) bool member pixels, ``seg_c`` (N,) int32
    segment ids (the first member's position; members contiguous, at most
    SEG_CAP of them), ``blocks`` (N,) int32 the row-major index of each
    lane's region in its grid (the dither counter), ``key`` the 32-bit
    dither key. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel on the current stream or raises.
    """
    _check_segment_inputs(packed_c, mask_c, seg_c, blocks)
    if not _on_card(packed_c, mask_c, seg_c, blocks):
        return segment_encode_reference(packed_c, mask_c, seg_c, blocks, cfg, key, emit_q)
    if cfg.crush_mode == "ladder" and not 1 <= cfg.ladder_k <= MAX_LADDER_K:
        raise ValueError(f"segment_encode_kernel takes ladder_k 1-{MAX_LADDER_K}, "
                         f"got {cfg.ladder_k}")
    dev, ch = packed_c.device, cfg.channels
    p, n = packed_c.shape

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # block-major copies: a warp reads a region's words 64 contiguous at a time
    packed_bm = packed_c.t().contiguous()
    mask_bm = mask_c.t().contiguous()
    f8_bm = empty(n, p)                                # the fit's factors, for the crush
    out = SegmentEncode(shifts=empty(3, n), q=empty(n, p) if emit_q else None,
                        dec=empty(n, p), dist_blk=empty(n, dtype=torch.float32),
                        count_blk=empty(n), count_mem=empty(n), eps=empty(6, ch, n),
                        avg=empty(ch, n, dtype=torch.float32))
    if n:
        args = (packed_bm.data_ptr(), mask_bm.data_ptr(), seg_c.contiguous().data_ptr(),
                blocks.contiguous().data_ptr(), n, p, ch, *launch.crush_args(cfg, key),
                f8_bm.data_ptr(), out.shifts.data_ptr(),
                None if out.q is None else out.q.data_ptr(), out.dec.data_ptr(),
                out.dist_blk.data_ptr(), out.count_blk.data_ptr(), out.count_mem.data_ptr(),
                out.eps.data_ptr(), out.avg.data_ptr())
        if p == BLOCK_AREA:
            _launch(f"segment_encode_p{p}", "limg_segment_encode", dev, *args)
        else:
            # from P = 1024 on: the segments with a member pixel, listed on
            # the card, and two counters
            scratch = empty(4 * n + 2)
            _launch(f"segment_encode_p{p}", "limg_segment_encode_region", dev, *args,
                    scratch.data_ptr(), library="segment_region")
    return out._replace(q=None if out.q is None else out.q.t(), dec=out.dec.t())
