"""Region reducers of the plain versions: one fixed order for every sum.

A reducer maps per-pixel arrays ``(..., P, N)`` or per-block rows
``(..., N)`` to per-region values broadcast back to every member block,
``(..., N)``. Floats are summed in one order that the CUDA kernels follow:

- inside a block of the fixed grid, of an RD region or of the run buffer,
  the halving tree ``x[:n/2] + x[n/2:]`` over its P pixels
  (``ops.fit.tree_sum``; in the region encode kernel, each thread's
  pixels t + (P / 8) j first, then one exchange across a region's warps
  at P = 1024 and 4096, then shuffles; in the segment kernel, one warp's
  shuffles);
- inside a block of a quadtree level, in either layout, the natural
  layout's order (``nat_block_sum``): a left fold over the block's 8 pixel
  rows of each column, then a pairwise-adjacent tree over the 8 columns
  (XLA's order for the JAX natural kernels' row fold, then their lane
  butterflies at x^1, x^2, x^4; limg_tpu/pallas_kernels/encode_natural.py
  :115-209). The Morton pair adds in this order too, so the two layouts
  give the same encode bit for bit, as the JAX package's do; against the
  JAX package's Morton kernels it flips fewer endpoints than the halving
  tree (tools/count_block_order_flips.py);
- across the blocks of a quadtree region, blocks in Morton order
  (ops/morton.py) and a pairwise-adjacent tree ``x[..., 0::2] +
  x[..., 1::2]``, which is what the JAX package's lane butterfly
  (limg_tpu/pallas_kernels/encode_merged.py:282 ``_butterfly``) computes;
  in the natural layout, x pairs then y pairs at each level of a square of
  a row-major block grid (``nat_pairwise``), which pairs blocks as the
  Morton tree does;
- across the blocks of a contiguous segment of the run-coalescing buffer
  (``SegmentReducer``), the doubling scan of ops/segments.py;
- across the blocks of a segment of any map (``ScatterReducer``), a left
  fold over its members in block order (ops/segments.py ``seg_sum``).

Every reducer but ``ScatterReducer`` gives each block its region's value;
``ScatterReducer`` gives each segment its value, (..., S), and
``to_blocks`` takes such values back to the blocks.

Integer sums wrap in int32 and, like min and max, do not depend on order.
``chunks`` is the most blocks a region can hold: the crush search's
block-error pre-scale depends on it (ops/crush.py ``err_scale_shift``).
"""

from __future__ import annotations

import torch

from .fit import _BIG, tree_sum
from .segments import SEG_ERR_SHIFT, fold_plan, seg_max, seg_min, seg_mixed_all, seg_sum


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


def nat_block_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., 64, N) -> (..., N): each block's sum in the natural layout's
    order, a left fold over its 8 pixel rows, then a pairwise-adjacent tree
    over the 8 column sums."""
    r = x.reshape(*x.shape[:-2], 8, 8, x.shape[-1])          # (..., row, col, N)
    s = r[..., 0, :, :]
    for row in range(1, 8):
        s = s + r[..., row, :, :]
    while s.shape[-2] > 1:
        s = s[..., 0::2, :] + s[..., 1::2, :]
    return s[..., 0, :]


def nat_pairwise(row: torch.Tensor, blocks_x: int, side: int, op) -> torch.Tensor:
    """Combine the aligned ``side`` x ``side`` squares of a row-major block
    grid ``blocks_x`` wide (both sides multiples of ``side``, a power of 2)
    by x pairs then y pairs at each level; broadcast back."""
    if side == 1:
        return row
    lead, n = row.shape[:-1], row.shape[-1]
    shape = (*lead, n // blocks_x // side, side, blocks_x // side, side)
    x = row.reshape(shape)
    while x.shape[-1] > 1:
        x = op(x[..., 0::2], x[..., 1::2])
        x = op(x[..., 0::2, :, :], x[..., 1::2, :, :])
    return x.expand(shape).reshape(row.shape)


class _Reducer:
    chunks = 1
    # block-error sums are shifted right by this before the cross-block sum
    seg_err_shift = 0

    def combine(self, row: torch.Tensor, op) -> torch.Tensor:
        raise NotImplementedError

    def to_blocks(self, values: torch.Tensor) -> torch.Tensor:
        """Region values as this reducer returns them -> each block's (..., N)."""
        return values

    def combine_sum(self, row):
        return self.combine(row, torch.add)

    def combine_max(self, row):
        return self.combine(row, torch.maximum)

    def combine_min(self, row):
        return self.combine(row, torch.minimum)

    def block_sum(self, x):
        """(..., P, N) -> each block's own sum (..., N)."""
        return tree_sum(x, -2)

    def sum(self, x):
        """(..., P, N) -> region sums (..., N)."""
        return self.combine_sum(self.block_sum(x))

    def max(self, x):
        return self.combine_max(x.amax(dim=-2))

    def min(self, x):
        return self.combine_min(x.amin(dim=-2))


class BlockReducer(_Reducer):
    """Each block is its own region (the fixed grid, and each level of the
    RD policy, whose blocks are regions of P pixels)."""

    def combine(self, row, op):
        return row


class _QuadReducer(_Reducer):
    """Blocks of a quadtree level, summed in the natural layout's in-block
    order (``nat_block_sum``)."""

    def block_sum(self, x):
        return nat_block_sum(x)


class GroupReducer(_QuadReducer):
    """Regions are aligned groups of ``group`` Morton-ordered blocks."""

    def __init__(self, group: int):
        self.group = group
        self.chunks = group

    def combine(self, row, op):
        return pairwise_tree(row, self.group, op)


class OwnerReducer(_QuadReducer):
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
    ``_SegReducer``). Per-block error sums of regions of 2048 pixels or
    more carry the pre-scale of ops/crush.py ``err_scale_shift``; each is
    shifted right by SEG_ERR_SHIFT less it before the cross-block sum.
    ``scan`` is the scan chain, ``seg_mixed_all`` or its kernel's wrapper
    (kernels/coalesce.py ``seg_mixed_all_kernel``)."""

    seg_err_shift = SEG_ERR_SHIFT

    def __init__(self, seg_c: torch.Tensor, scan=seg_mixed_all):
        self.seg_c = seg_c
        self.scan = scan

    def combine(self, row, op):
        rows = row.reshape(-1, row.shape[-1])
        if op is torch.add:
            out = self.scan(rows, self.seg_c, rows.shape[0])
        elif op is torch.maximum:
            out = self.scan(rows, self.seg_c, 0)
        elif op is torch.minimum:
            out = -self.scan(-rows, self.seg_c, 0)
        else:
            raise ValueError(f"no segment scan for {op}")
        return out.reshape(row.shape)


class ScatterReducer(_Reducer):
    """Regions are the segments of any map ``seg_id`` (N,) of ids in [0, S),
    members anywhere (the JAX package's scatter form,
    limg_tpu/ops/segments.py:44, :222-235). Values are per segment, (..., S);
    a segment with no member keeps the reduction's start: 0 for a sum, for
    a maximum (minimum) 0 on integers and -(+)3.4e38 on floats, as the JAX
    package starts them. Block errors shift right by SEG_ERR_SHIFT less the
    block's pre-scale before the sum, as a contiguous segment's."""

    seg_err_shift = SEG_ERR_SHIFT

    def __init__(self, seg_id: torch.Tensor, num_segments: int):
        self.seg_id = seg_id
        self.num_segments = num_segments
        self._plan = None

    def _fold_plan(self, row: torch.Tensor):
        """The float sums' plan on a card, built once (ops/segments.py
        ``fold_plan``); the CPU's ``index_add_`` needs none."""
        if row.device.type == "cpu" or not row.is_floating_point():
            return None
        if self._plan is None:
            self._plan = fold_plan(self.seg_id, self.num_segments)
        return self._plan

    def combine_sum(self, row):
        return seg_sum(row, self.seg_id, self.num_segments, self._fold_plan(row))

    def combine_max(self, row):
        return seg_max(row, self.seg_id, self.num_segments,
                       -_BIG if row.is_floating_point() else 0)

    def combine_min(self, row):
        return seg_min(row, self.seg_id, self.num_segments,
                       _BIG if row.is_floating_point() else 2**31 - 1)

    def to_blocks(self, values):
        """(..., S) segment values -> (..., N); a (K, 3, S) table of
        candidate shifts expanded with stride 0 (ops/crush.py
        ``_const_cands``) stays one, as kernels/crush_eval.py reads it."""
        n = self.seg_id.shape[0]
        if values.shape[-1] > 1 and values.stride(-1) == 0:
            return values[..., :1].expand(*values.shape[:-1], n)
        return values[..., self.seg_id.to(torch.int64)]


class NatGroupReducer(_QuadReducer):
    """Regions are the aligned 2^lvl x 2^lvl squares of a row-major block
    grid (encode_natural.py:152 ``NatGroupReducer``)."""

    def __init__(self, lvl: int, blocks_x: int):
        self.side = 1 << lvl
        self.blocks_x = blocks_x
        self.chunks = 4 ** lvl

    def combine(self, row, op):
        return nat_pairwise(row, self.blocks_x, self.side, op)


class NatOwnerReducer(_QuadReducer):
    """Each block's region is its own owner-level square of a row-major
    block grid (encode_natural.py:179 ``NatOwnerReducer``)."""

    def __init__(self, owner: torch.Tensor, levels: int, blocks_x: int):
        self.owner = owner
        self.levels = levels
        self.blocks_x = blocks_x
        self.chunks = 4 ** (levels - 1)

    def combine(self, row, op):
        out = row
        for lvl in range(1, self.levels):
            out = torch.where(self.owner == lvl, nat_pairwise(row, self.blocks_x, 1 << lvl, op),
                              out)
        return out
