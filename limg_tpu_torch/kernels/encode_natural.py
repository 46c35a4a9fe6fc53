"""Natural-layout quadtree encode: the two CUDA kernels' wrappers and plain
versions.

``fit_levels_natural_kernel`` takes the role of the JAX package's
``fit_levels_natural`` (limg_tpu/pallas_kernels/encode_natural.py:421) and
``owner_crush_natural_kernel`` that of ``owner_crush_natural`` (:528): the
functions of ``fit_levels_kernel`` and ``owner_crush_kernel``
(kernels/encode_merged.py) on the row-major image. Both pairs sum a block
in the natural layout's order (ops/reduce.py ``nat_block_sum``: a left
fold over the block's 8 pixel rows, then a pairwise tree over its 8
columns), and across the blocks of a quadtree square this pair combines
blocks as the Morton pair does (``nat_pairwise``: x pairs, then y pairs,
at each level), so the two layouts give the same encode bit for bit.

They return the ``FitLevels`` / ``OwnerCrush`` tuples of
kernels/quadtree.py, per-block rows in row-major block order, except
that ``f8_sel``, ``q`` and ``dec`` are natural (8 * blocks_y, 8 *
blocks_x) int32 planes: the padded image's own layout, which the decoded
image is without a relayout. ``owner_crush_natural_kernel`` takes
``f8_sel`` in that layout, and an ``owner`` map uniform over each region,
as the fit writes it.

The JAX kernels' TPU machinery has no counterpart here: the (64, 512) tile
geometry and its ``_C_W`` padding, the one-hot MXU compaction of
lane-replicated rows (``_compact`` / ``_expand``, :212-238),
``rows_to_blocks`` (:248) and the 8-lane replication of block values.

On a CUDA tensor each wrapper launches ``csrc/encode_natural.cu`` (built at
first use) or raises; on a CPU tensor it runs the plain version, which
works in row-major block order on a grid padded to whole top-level squares
with the natural reducers of ops/reduce.py. The two agree bit for bit on
the card.
"""

from __future__ import annotations

import torch

from ..config import EncodeConfig
from ..ops import layout
from ..ops.dither import dither_key
from ..ops.reduce import NatGroupReducer, NatOwnerReducer, nat_pairwise
from . import launch
from .quadtree import (FitLevels, OwnerCrush, check_owner_regions, check_words, fit_levels_body,
                       owner_crush_body, words_on_card)


class NatBlocks:
    """The plain versions' block order for the natural kernels: the block
    grid of the (h, w) image padded to whole top-level squares of
    2^(levels-1) blocks a side, in row-major block order; the members of
    kernels/encode_merged.py ``MortonBlocks``, which the plain bodies of
    kernels/quadtree.py use, with the natural reducers."""

    def __init__(self, words: torch.Tensor, levels: int):
        h, w = words.shape
        g = 1 << (levels - 1)
        self.grid = layout.grid_for(h, w)
        by, bx = self.grid.blocks_y, self.grid.blocks_x
        self.padded = layout.BlockGrid(h, w, -(-by // g) * g, -(-bx // g) * g)
        self.blocks_x = self.padded.blocks_x
        self.yy = torch.arange(self.padded.blocks_y, device=words.device)[:, None]
        self.xx = torch.arange(self.padded.blocks_x, device=words.device)[None, :]
        self.packed, self.mask, _ = layout.blockify_words(words, grid=self.padded)
        # each padded block's row-major index in the image's grid (its dither
        # counter; 0 for padding blocks, whose outputs are dropped)
        in_grid = (self.yy < by) & (self.xx < bx)
        self.dither_blocks = torch.where(in_grid, self.yy * bx + self.xx, 0).reshape(-1)

    def group_reducer(self, lvl: int):
        return NatGroupReducer(lvl, self.blocks_x)

    def owner_reducer(self, owner: torch.Tensor, levels: int):
        return NatOwnerReducer(self.embed(owner), levels, self.blocks_x)

    def leads(self, lvl: int) -> torch.Tensor:
        side = 1 << lvl
        return ((self.yy % side == 0) & (self.xx % side == 0)).reshape(-1)

    def first_children(self, lvl: int) -> torch.Tensor:
        c = 1 << (lvl - 1)
        return (((self.yy & c) == 0) & ((self.xx & c) == 0)).reshape(-1)

    def first_of(self, row: torch.Tensor, lvl: int) -> torch.Tensor:
        side, lead = 1 << lvl, row.shape[:-1]
        shape = (*lead, self.padded.blocks_y // side, side, self.blocks_x // side, side)
        return row.reshape(shape)[..., :1, :, :1].expand(shape).reshape(row.shape)

    def combine(self, row: torch.Tensor, lvl: int, op) -> torch.Tensor:
        return nat_pairwise(row, self.blocks_x, 1 << lvl, op)

    def embed(self, rows: torch.Tensor) -> torch.Tensor:
        """(..., NB) -> (..., NBP), padding blocks 0."""
        lead = rows.shape[:-1]
        out = rows.new_zeros((*lead, self.padded.blocks_y, self.padded.blocks_x))
        out[..., :self.grid.blocks_y, :self.grid.blocks_x] = rows.reshape(
            *lead, self.grid.blocks_y, self.grid.blocks_x)
        return out.reshape(*lead, -1)

    def restore(self, rows: torch.Tensor) -> torch.Tensor:
        """(..., NBP) -> (..., NB): drop the padding blocks."""
        lead = rows.shape[:-1]
        r = rows.reshape(*lead, self.padded.blocks_y, self.padded.blocks_x)
        return r[..., :self.grid.blocks_y, :self.grid.blocks_x].reshape(*lead, -1)

    def embed_pixels(self, plane: torch.Tensor) -> torch.Tensor:
        """A natural (8 * blocks_y, 8 * blocks_x) plane -> (64, NBP)."""
        return layout.blockify_words(plane, grid=self.padded)[0]

    def restore_pixels(self, px: torch.Tensor) -> torch.Tensor:
        """(64, NBP) -> the natural (8 * blocks_y, 8 * blocks_x) plane."""
        return layout.block_plane(self.restore(px), self.grid).contiguous()


def _check_plane(name: str, t: torch.Tensor, grid: layout.BlockGrid, device) -> None:
    shape = (8 * grid.blocks_y, 8 * grid.blocks_x)
    if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name} must be a natural {shape} int32 plane on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def fit_levels_natural_reference(words: torch.Tensor, cfg: EncodeConfig,
                                 levels: int) -> FitLevels:
    """Plain PyTorch version of the natural fit kernel, on any device."""
    check_words(words, levels)
    return fit_levels_body(NatBlocks(words, levels), cfg, levels)


def owner_crush_natural_reference(words: torch.Tensor, owner: torch.Tensor,
                                  f8_sel: torch.Tensor, eps_sel: torch.Tensor,
                                  cfg: EncodeConfig, levels: int, seed: int,
                                  emit_q: bool = True) -> OwnerCrush:
    """Plain PyTorch version of the natural crush kernel, on any device."""
    check_words(words, levels)
    check_owner_regions(words, owner, levels)
    return owner_crush_body(NatBlocks(words, levels), owner, f8_sel, eps_sel, cfg, levels, seed,
                            emit_q)


def fit_levels_natural_kernel(words: torch.Tensor, cfg: EncodeConfig, levels: int) -> FitLevels:
    """All-levels fit, merge test and owner select in the natural layout;
    see the module docstring. A CPU tensor goes to the plain version; a
    CUDA tensor launches the kernel on the current stream or raises."""
    check_words(words, levels)
    if not words_on_card(words):
        return fit_levels_natural_reference(words, cfg, levels)
    dev = words.device
    h, w = words.shape
    grid = layout.grid_for(h, w)
    ch, nb = cfg.channels, grid.num_blocks

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = FitLevels(cnt0=empty(nb), f8_sel=empty(8 * grid.blocks_y, 8 * grid.blocks_x),
                    eps_sel=empty(6, ch, nb), avg_sel=empty(ch, nb, dtype=torch.float32),
                    owner=empty(nb), stats_bits=empty(nb), reasons=empty(levels - 1, nb))
    launch.call(launch.library("encode_natural"), "limg_fit_levels_natural",
                "fit_levels_natural", dev, words.data_ptr(), h, w, ch, levels, cfg.num_factors,
                *(t.data_ptr() for t in out))
    return out


def owner_crush_natural_kernel(words: torch.Tensor, owner: torch.Tensor, f8_sel: torch.Tensor,
                               eps_sel: torch.Tensor, cfg: EncodeConfig, levels: int,
                               seed: int, emit_q: bool = True) -> OwnerCrush:
    """Crush, dither and decode at each block's owner level in the natural
    layout; see the module docstring. A CPU tensor goes to the plain
    version; a CUDA tensor launches the kernel on the current stream or
    raises."""
    check_words(words, levels)
    ch = cfg.channels
    grid = layout.grid_for(*words.shape)
    nb = grid.num_blocks
    for name, t, shape in (("owner", owner, (nb,)), ("eps_sel", eps_sel, (6, ch, nb))):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != words.device:
            raise ValueError(f"{name} must be {shape} int32 on {words.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    _check_plane("f8_sel", f8_sel, grid, words.device)
    if not words_on_card(words):
        return owner_crush_natural_reference(words, owner, f8_sel, eps_sel, cfg, levels, seed,
                                             emit_q)
    dev = words.device
    h, w = words.shape

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    plane = (8 * grid.blocks_y, 8 * grid.blocks_x)
    # every buffer the kernel reads is held here until it is enqueued
    owner, f8_sel, eps_sel = owner.contiguous(), f8_sel.contiguous(), eps_sel.contiguous()
    shifts, dec, bpp = empty(3, nb), empty(*plane), empty(nb)
    q = empty(*plane) if emit_q else None
    dist, dist_blk = empty(nb, dtype=torch.float32), empty(nb, dtype=torch.float32)
    launch.call(launch.library("encode_natural"), "limg_owner_crush_natural",
                "owner_crush_natural", dev, words.data_ptr(), h, w, ch, levels,
                *launch.crush_args(cfg, dither_key(seed, cfg.dither_seed)),
                owner.data_ptr(), f8_sel.data_ptr(), eps_sel.data_ptr(), shifts.data_ptr(),
                None if q is None else q.data_ptr(), dec.data_ptr(), dist.data_ptr(),
                dist_blk.data_ptr(), bpp.data_ptr())
    return OwnerCrush(shifts=shifts, q=q, dec=dec, dist=dist, dist_blk=dist_blk, bpp=bpp)
