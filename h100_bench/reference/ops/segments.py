"""Segment reductions, and the segment refit and crush.

The counterpart of limg_tpu/ops/segments.py. A segment map gives each
block of the (..., NB) last axis its segment's id. Two forms:

- The scatter form (``seg_sum`` / ``seg_max`` / ``seg_min``, ``fit_segments``
  and ``find_shifts_segments`` with ``contiguous=False``): any map of ids in
  [0, S), members anywhere, per-segment values (..., S). A segment with no
  member keeps the reduction's start (0, or ``init``). A float sum is a
  left fold over the members in block order, starting from 0.0, which is
  what the JAX package's scatter-add computes on XLA:CPU and what
  ``index_add_`` computes on the CPU; on a card it is the kernel of
  kernels/seg_fold.py, which folds in the same order (``index_add_`` on a
  card adds with atomics, in an order that changes from run to run).
  Integer sums wrap in int32 and, like max and min, do not depend on order.
- The contiguous form (``seg_*_contig``, ``seg_*_all``, ``seg_mixed_all``,
  and ``contiguous=True``): the members of a segment are adjacent and, in
  the coalesce buffer, the id is the segment's first position. Every lane
  gets its segment's total by two Hillis-Steele scans: steps ``d = 1, 2,
  4, ...`` while ``d < min(SEG_CAP, N)``, the forward scan combining lane
  ``i - d`` into lane ``i`` when ``seg[i - d] == seg[i]`` and the backward
  scan lane ``i + d`` when ``seg[i + d] == seg[i]``. Sums finish as ``fwd +
  bwd - x``, maxima as ``max(fwd, bwd)``, and a minimum is ``-max(-x)``. In
  float32 ``fwd + bwd - x`` is not the segment's exact sum and can differ
  between members: it is the value the CUDA kernel (csrc/coalesce.cu
  ``seg_scan_kernel``) and the JAX package compute, in the same order. A
  lane's result depends only on lanes within SEG_CAP - 1 of it, so
  segments of up to SEG_CAP lanes get their whole total. On a card the
  chain is the scan kernel's (kernels/coalesce.py ``seg_mixed_all_kernel``).

``fit_segments`` and ``find_shifts_segments`` are the fit and crush search
of ops/fit.py ``fit_regions`` and ops/crush.py ``find_shifts`` with a
segment reducer (ops/reduce.py ``ScatterReducer`` or ``SegmentReducer``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fit import Decomposition, fit_regions

# Most members of one segment: the scan's reach and the run caps of
# run building (limg_tpu/ops/segments.py:36-41).
SEG_CAP = 256
# Per-block integer error sums are shifted right by this before the
# cross-block sum, so a whole segment's error fits int32; admissibility
# then compares in float32 (limg_tpu/ops/segments.py:33-36, :419).
SEG_ERR_SHIFT = 8


def scan_steps(n: int) -> list[int]:
    """The doubling steps of a chain over ``n`` lanes."""
    steps, d = [], 1
    while d < min(SEG_CAP, n):
        steps.append(d)
        d *= 2
    return steps


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    pad = torch.full((*x.shape[:-1], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _shift_left(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    pad = torch.full((*x.shape[:-1], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def seg_mixed_all(x: torch.Tensor, seg_c: torch.Tensor, n_sum: int, init_max=0) -> torch.Tensor:
    """One doubling-scan chain over the rows of ``x`` (R, N): rows ``[:n_sum]``
    are summed, the rest maxed; ``seg_c`` (N,) int. Returns (R, N), each
    lane holding its segment's total. ``init_max`` only fills lanes shifted
    in from outside the array, which a guard on a real id never takes."""
    r = x.shape[0]
    is_sum = (torch.arange(r, device=x.device) < n_sum)[:, None]
    fill = torch.where(is_sum, torch.zeros((), dtype=x.dtype, device=x.device),
                       torch.tensor(init_max, dtype=x.dtype, device=x.device))

    def comb(a, b):
        if n_sum == r:
            return a + b
        if n_sum == 0:
            return torch.maximum(a, b)
        return torch.where(is_sum, a + b, torch.maximum(a, b))

    fwd, bwd = x, x
    for d in scan_steps(x.shape[-1]):
        pad = fill.expand(r, d)
        prev = torch.cat([pad, fwd[:, :-d]], dim=-1)
        fwd = torch.where(_shift_right(seg_c, d, -1) == seg_c, comb(fwd, prev), fwd)
        nxt = torch.cat([bwd[:, d:], pad], dim=-1)
        bwd = torch.where(_shift_left(seg_c, d, -2) == seg_c, comb(bwd, nxt), bwd)
    if n_sum == r:
        return fwd + bwd - x
    if n_sum == 0:
        return torch.maximum(fwd, bwd)
    return torch.where(is_sum, fwd + bwd - x, torch.maximum(fwd, bwd))


def _scan_chain(x: torch.Tensor):
    """The plain doubling-scan chain on every device."""
    return seg_mixed_all


def _chain_rows(x: torch.Tensor, seg_c: torch.Tensor, n_sum_all: bool, init) -> torch.Tensor:
    rows = x.reshape(-1, x.shape[-1])
    out = _scan_chain(x)(rows, seg_c, rows.shape[0] if n_sum_all else 0, init)
    return out.reshape(x.shape)


def seg_sum_all(x: torch.Tensor, seg_c: torch.Tensor) -> torch.Tensor:
    """Per-member segment sums of (..., N) rows over contiguous segments."""
    return _chain_rows(x, seg_c, True, 0)


def seg_max_all(x: torch.Tensor, seg_c: torch.Tensor, init) -> torch.Tensor:
    """Per-member segment maxima of (..., N) rows over contiguous segments."""
    return _chain_rows(x, seg_c, False, init)


def seg_min_all(x: torch.Tensor, seg_c: torch.Tensor, init) -> torch.Tensor:
    """Per-member segment minima of (..., N) rows: -max(-x), exact."""
    return -_chain_rows(-x, seg_c, False, -init)


def _dense_by_start(total: torch.Tensor, seg_c: torch.Tensor, num_segments: int, init):
    """Per-member totals -> the dense (..., S) form with S = N: each segment's
    value at its first position (its id), ``init`` elsewhere."""
    n = total.shape[-1]
    if num_segments != n:
        raise ValueError(f"the contiguous form has one segment slot a lane: "
                         f"num_segments must be {n}, got {num_segments}")
    pos = torch.arange(n, device=total.device)
    return torch.where(pos == seg_c, total, torch.tensor(init, dtype=total.dtype,
                                                         device=total.device))


def seg_sum_contig(x: torch.Tensor, seg_c: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _dense_by_start(seg_sum_all(x, seg_c), seg_c, num_segments, 0)


def seg_max_contig(x: torch.Tensor, seg_c: torch.Tensor, num_segments: int, init) -> torch.Tensor:
    return _dense_by_start(seg_max_all(x, seg_c, init), seg_c, num_segments, init)


def seg_min_contig(x: torch.Tensor, seg_c: torch.Tensor, num_segments: int, init) -> torch.Tensor:
    return _dense_by_start(seg_min_all(x, seg_c, init), seg_c, num_segments, init)


# ---------------------------------------------------------------------------
# The scatter form: any segment map
# ---------------------------------------------------------------------------

class FoldPlan(NamedTuple):
    """A segment map's blocks in fold order: ``order`` (NB,) int32, the block
    indices stably sorted by segment id; ``starts`` (S + 1,) int32, each
    segment's first slot in ``order`` (a segment with no member: an empty
    range)."""

    order: torch.Tensor
    starts: torch.Tensor


def fold_plan(seg_id: torch.Tensor, num_segments: int) -> FoldPlan:
    """The fold plan of ``seg_id`` (NB,) with ids in [0, num_segments), on
    its device (kernels/seg_fold.py)."""
    ids = seg_id.to(torch.int64)
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int64, device=ids.device)
    return FoldPlan(order.to(torch.int32),
                    torch.searchsorted(sorted_ids, bounds).to(torch.int32))


def seg_sum_plain(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``seg_sum`` by ``index_add_``: on the CPU a left fold over each
    segment's members in block order; integer sums wrap, in any order."""
    rows = x.reshape(-1, x.shape[-1])
    out = torch.zeros((rows.shape[0], num_segments), dtype=x.dtype, device=x.device)
    out.index_add_(1, seg_id.to(torch.int64), rows)
    return out.reshape(*x.shape[:-1], num_segments)


def seg_sum(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int,
            plan: FoldPlan | None = None) -> torch.Tensor:
    """Sum per-block values (..., NB) into per-segment (..., S), from 0, by
    the plain ``index_add_`` on every device (``plan`` is not needed)."""
    return seg_sum_plain(x, seg_id, num_segments)


def _seg_reduce(x, seg_id, num_segments: int, init, how: str) -> torch.Tensor:
    rows = x.reshape(-1, x.shape[-1])
    out = torch.full((rows.shape[0], num_segments), init, dtype=x.dtype, device=x.device)
    idx = seg_id.to(torch.int64)[None].expand_as(rows)
    out.scatter_reduce_(1, idx, rows, how, include_self=True)
    return out.reshape(*x.shape[:-1], num_segments)


def seg_max(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int, init) -> torch.Tensor:
    """Per-segment maxima (..., S), starting from ``init``."""
    return _seg_reduce(x, seg_id, num_segments, init, "amax")


def seg_min(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int, init) -> torch.Tensor:
    """Per-segment minima (..., S), starting from ``init``."""
    return _seg_reduce(x, seg_id, num_segments, init, "amin")


def gather_decomp(d: Decomposition, seg_id: torch.Tensor) -> Decomposition:
    """Per-segment decomposition (ch, S) -> per-block (ch, NB)."""
    idx = seg_id.to(torch.int64)
    return Decomposition(*(f[..., idx] for f in d))


# ---------------------------------------------------------------------------
# The segment refit and crush
# ---------------------------------------------------------------------------

def _reducer(seg_id: torch.Tensor, num_segments: int, contiguous: bool, like: torch.Tensor):
    # ops/reduce.py and ops/crush.py import this module: import them at call time
    from .reduce import ScatterReducer, SegmentReducer

    if contiguous:
        return SegmentReducer(seg_id, _scan_chain(like))
    return ScatterReducer(seg_id, num_segments)


def fit_segments(px_u8: torch.Tensor, mask: torch.Tensor, seg_id: torch.Tensor,
                 num_segments: int, channels: int, contiguous: bool = False) -> Decomposition:
    """The 3-axis fit of every segment (ops/fit.py ``fit_regions``, its
    reductions keyed by ``seg_id``); ``px_u8`` (>=ch, P, NB), ``mask`` (P, NB)
    bool.

    ``contiguous=False``: any map of ids in [0, S); returns (ch, S) fields,
    a segment with no member all zeros. ``contiguous=True`` (members
    adjacent, the id the first member's position, S = NB): returns
    per-member fields (ch, NB), each member carrying its segment's values.
    """
    red = _reducer(seg_id, num_segments, contiguous, px_u8)
    return fit_regions(px_u8, mask, channels, red)[0]


def find_shifts_segments(px_u8, mask, f8_u8, d_seg: Decomposition, seg_id: torch.Tensor,
                         num_segments: int, cfg, contiguous: bool = False):
    """The crush search with one shift triple a segment (ops/crush.py
    ``find_shifts``, the pixel maxima and block errors reduced over each
    segment, the errors shifted right by SEG_ERR_SHIFT first).

    ``contiguous=False``: ``d_seg`` (ch, S) from ``fit_segments``; returns
    (shifts (3, S), block_err (S,)), a segment with no member (0, 0, 0) and
    2^31 - 1. ``contiguous=True``: ``d_seg`` per member, as
    ``fit_segments(contiguous=True)`` gives it; returns (3, NB) / (NB,) per
    member.

    On a card, blocks of at most 256 pixels evaluate every batch of
    candidates with kernels/crush_eval.py ``crush_eval_rows_kernel``, as the
    JAX package takes its Pallas evaluation there
    (limg_tpu/ops/segments.py:402-405); larger blocks take the plain
    evaluation on the card, as the JAX package's jnp evaluation does.
    """
    from .crush import find_shifts

    red = _reducer(seg_id, num_segments, contiguous, px_u8)
    d_blk = d_seg if contiguous else gather_decomp(d_seg, seg_id)
    use_kernel = False
    return find_shifts(px_u8, mask, f8_u8, d_blk, cfg, red, use_kernel=use_kernel)
