"""Region reducers of the plain versions: one fixed order for every sum.

A reducer maps per-pixel arrays ``(..., 64, N)`` or per-block rows
``(..., N)`` to per-region values broadcast back to every member block,
``(..., N)``. Floats are summed in one order that the CUDA kernels follow:

- inside a block, the halving tree ``x[:n/2] + x[n/2:]`` over the 64
  pixels (``ops.fit.tree_sum``; in a kernel, one warp's shuffles);
- across the blocks of a region, blocks in Morton order (ops/morton.py)
  and a pairwise-adjacent tree ``x[..., 0::2] + x[..., 1::2]``, which is
  what the JAX package's lane butterfly (limg_tpu/pallas_kernels/
  encode_merged.py:282 ``_butterfly``) computes; in a kernel, a
  shared-memory tree over the warps of the region;
- across the blocks of a contiguous segment of the run-coalescing buffer
  (``SegmentReducer``), the doubling scan of ops/segments.py.

Integer sums wrap in int32 and, like min and max, do not depend on order.
``chunks`` is the most blocks a region can hold: the crush search's
block-error pre-scale depends on it (ops/crush.py ``err_scale_shift``).
"""

from __future__ import annotations

import torch

from .fit import tree_sum
from .segments import SEG_ERR_SHIFT, seg_mixed_all


def pairwise_tree(row: torch.Tensor, group: int, op) -> torch.Tensor:
    """Combine aligned groups of ``group`` (a power of 4, or 1) entries of
    the last axis by a pairwise-adjacent tree; broadcast back."""
    if group == 1:
        return row
    n = row.shape[-1]
    x = row.reshape(*row.shape[:-1], n // group, group)
    while x.shape[-1] > 1:
        x = op(x[..., 0::2], x[..., 1::2])
    return x.expand(*row.shape[:-1], n // group, group).reshape(row.shape)


class _Reducer:
    chunks = 1
    # block-error sums are shifted right by this before the cross-block sum
    seg_err_shift = 0

    def combine(self, row: torch.Tensor, op) -> torch.Tensor:
        raise NotImplementedError

    def combine_sum(self, row):
        return self.combine(row, torch.add)

    def combine_max(self, row):
        return self.combine(row, torch.maximum)

    def combine_min(self, row):
        return self.combine(row, torch.minimum)

    def sum(self, x):
        """(..., 64, N) -> region sums (..., N)."""
        return self.combine_sum(tree_sum(x, -2))

    def max(self, x):
        return self.combine_max(x.amax(dim=-2))

    def min(self, x):
        return self.combine_min(x.amin(dim=-2))


class BlockReducer(_Reducer):
    """Each block is its own region (the fixed grid)."""

    def combine(self, row, op):
        return row


class GroupReducer(_Reducer):
    """Regions are aligned groups of ``group`` Morton-ordered blocks."""

    def __init__(self, group: int):
        self.group = group
        self.chunks = group

    def combine(self, row, op):
        return pairwise_tree(row, self.group, op)


class OwnerReducer(_Reducer):
    """Each block's region is its own owner-level group: the aligned group
    of 4^owner Morton-ordered blocks holding it (``owner``: (N,) int)."""

    def __init__(self, owner: torch.Tensor, levels: int):
        self.owner = owner
        self.levels = levels
        self.chunks = 4 ** (levels - 1)

    def combine(self, row, op):
        out = row
        for lvl in range(1, self.levels):
            out = torch.where(self.owner == lvl, pairwise_tree(row, 4 ** lvl, op), out)
        return out


class SegmentReducer(_Reducer):
    """Regions are contiguous segments of the last axis, ``seg_c`` (N,) the
    segment id of each block (limg_tpu/pallas_kernels/encode_segments.py:63
    ``_SegReducer``). Per-block error sums carry no pre-scale and are
    shifted right by SEG_ERR_SHIFT before the cross-block sum."""

    seg_err_shift = SEG_ERR_SHIFT

    def __init__(self, seg_c: torch.Tensor):
        self.seg_c = seg_c

    def combine(self, row, op):
        rows = row.reshape(-1, row.shape[-1])
        if op is torch.add:
            out = seg_mixed_all(rows, self.seg_c, rows.shape[0])
        elif op is torch.maximum:
            out = seg_mixed_all(rows, self.seg_c, 0)
        elif op is torch.minimum:
            out = -seg_mixed_all(-rows, self.seg_c, 0)
        else:
            raise ValueError(f"no segment scan for {op}")
        return out.reshape(row.shape)
