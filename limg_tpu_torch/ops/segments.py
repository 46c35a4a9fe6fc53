"""Contiguous-segment reductions: the doubling-scan chain of run coalescing.

The counterpart of limg_tpu/ops/segments.py (``seg_mixed_all_jnp`` :173;
its ``seg_sum_all`` / ``seg_max_all`` / ``seg_min_all`` :144-154 are one-row
chains, kernels/coalesce.py ``seg_sum_all`` / ``seg_min_all``). A segment
map ``seg_c`` (N,) gives each lane its segment's id; members of a segment
are contiguous and, in the coalesce buffer, the id is the segment's first
position. Every lane gets its segment's total by two Hillis-Steele scans:
steps ``d = 1, 2, 4, ...`` while ``d < min(SEG_CAP, N)``, the forward scan
combining lane ``i - d`` into lane ``i`` when ``seg[i - d] == seg[i]`` and
the backward scan lane ``i + d`` when ``seg[i + d] == seg[i]``. Sums finish
as ``fwd + bwd - x``, maxima as ``max(fwd, bwd)``, and a minimum is
``-max(-x)``. In float32 ``fwd + bwd - x`` is not the segment's exact sum
and can differ between members: it is the value the CUDA kernel
(csrc/coalesce.cu ``seg_scan_kernel``) and the JAX package compute, in the
same order.

A lane's result depends only on lanes within SEG_CAP - 1 of it, so
segments of up to SEG_CAP lanes get their whole total.
"""

from __future__ import annotations

import torch

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
