"""Fused quadtree encode: the two CUDA kernels' wrappers and plain versions.

``fit_levels_kernel`` takes the role of the JAX package's
``fit_levels_pallas(emit_match=True)``
(limg_tpu/pallas_kernels/encode_merged.py:813): it fits every quadtree
level, runs the 27-probe merge test of each child against its group's
first child, the alive chain, the owner level and the owner select, and
the stats rows. ``owner_crush_kernel`` takes the role of
``owner_crush_pallas`` (:902): the crush search, dither and decode once per
pixel at each block's owner level.

Both read the row-major (H, W) int32 word image (RGBA bytes, R lowest) and
compute the validity mask from (h, w). Their per-block outputs are in
row-major block order; pixel planes are ``(64, NB)``:

    fit:   FitLevels(cnt0 (NB,) i32, f8_sel (64, NB) i32 packed factors,
           eps_sel (6, ch, NB) i32, avg_sel (ch, NB) f32, owner (NB,) i32,
           stats_bits (NB,) i32, reasons (levels-1, NB) i32)
    crush: OwnerCrush(shifts (3, NB) i32, q (64, NB) i32 or None,
           dec (64, NB) i32, dist (NB,) f32 per region, dist_blk (NB,) f32
           per block, bpp (NB,) i32)

``stats_bits`` bit l marks a nonempty level-l region's top-left block whose
owner level is >= l; ``reasons[l-1]`` holds the level-l merge decision's
MATCH_REASON_BITS at nonempty level-l top-left blocks, 0 elsewhere. The
crush takes an ``owner`` map that is uniform over each region, as the fit
writes it: its kernel reads a region's owner from any of its blocks, and
its plain version raises on any other map (``check_owner_regions``).

On a CUDA tensor each wrapper launches ``csrc/encode_merged.cu`` (built at
first use) or raises; on a CPU tensor it runs the plain version, which
works in Morton block order (ops/morton.py) with the reducers of
ops/reduce.py, so that it adds floats in the kernel's order: a block in
the natural layout's order (``nat_block_sum``, as the natural pair of
kernels/encode_natural.py does, so the two layouts encode alike), a
region's blocks by the pairwise tree. The two agree bit for bit on the
card.
"""

from __future__ import annotations

import torch

from ..config import BLOCK_AREA, EncodeConfig
from ..ops import layout
from ..ops.dither import dither_key
from ..ops.morton import MortonOrder, morton_mask
from ..ops.reduce import GroupReducer, OwnerReducer, pairwise_tree
from . import launch
from .quadtree import (FitLevels, OwnerCrush, check_owner_regions, check_words, fit_levels_body,
                       owner_crush_body, words_on_card)


def _first_of_group(row: torch.Tensor, group: int) -> torch.Tensor:
    """Broadcast the first entry of each aligned group of the last axis."""
    n = row.shape[-1]
    x = row.reshape(*row.shape[:-1], n // group, group)[..., :1]
    return x.expand(*row.shape[:-1], n // group, group).reshape(row.shape)


class MortonBlocks:
    """The plain versions' block order for the Morton kernels: the grid
    padded to whole top-level squares, in Morton order (ops/morton.py), so
    that a level-l region is an aligned group of 4^l lanes. The natural
    layout's counterpart is kernels/encode_natural.py ``NatBlocks``; the
    plain bodies of kernels/quadtree.py take either.

    ``packed`` / ``mask`` (64, NBP) are the padded blocks' words and real
    pixels; ``embed`` / ``restore`` move per-block rows (..., NB) in and
    out of that order, ``embed_pixels`` / ``restore_pixels`` the kernels'
    (64, NB) pixel planes; ``dither_blocks`` (NBP,) is each block's index
    in the image's grid (its dither counter)."""

    def __init__(self, words: torch.Tensor, levels: int):
        h, w = words.shape
        packed, _, grid = layout.blockify_words(words)
        self.order = MortonOrder(grid.blocks_y, grid.blocks_x, levels, words.device)
        self.packed = self.order.embed(packed)
        self.mask = morton_mask(h, w, levels, words.device)
        self.lane = torch.arange(self.order.num_padded, device=words.device)
        self.dither_blocks = self.order.perm.clamp(min=0)

    def group_reducer(self, lvl: int):
        return GroupReducer(4 ** lvl)

    def owner_reducer(self, owner: torch.Tensor, levels: int):
        return OwnerReducer(self.embed(owner), levels)

    def leads(self, lvl: int) -> torch.Tensor:
        """(NBP,) bool: the first blocks of the level-lvl regions."""
        return (self.lane & (4 ** lvl - 1)) == 0

    def first_children(self, lvl: int) -> torch.Tensor:
        """(NBP,) bool: the blocks of each level-lvl region's first child."""
        return (self.lane & (4 ** lvl - 4 ** (lvl - 1))) == 0

    def first_of(self, row: torch.Tensor, lvl: int) -> torch.Tensor:
        """Broadcast each level-lvl region's first entry over it."""
        return _first_of_group(row, 4 ** lvl)

    def combine(self, row: torch.Tensor, lvl: int, op) -> torch.Tensor:
        """Combine each level-lvl region by the pairwise tree; broadcast."""
        return pairwise_tree(row, 4 ** lvl, op)

    def embed(self, rows: torch.Tensor) -> torch.Tensor:
        return self.order.embed(rows)

    def restore(self, rows: torch.Tensor) -> torch.Tensor:
        return self.order.restore(rows)

    embed_pixels = embed
    restore_pixels = restore


def fit_levels_reference(words: torch.Tensor, cfg: EncodeConfig, levels: int) -> FitLevels:
    """Plain PyTorch version of the fit kernel, on any device."""
    check_words(words, levels)
    return fit_levels_body(MortonBlocks(words, levels), cfg, levels)


def owner_crush_reference(words: torch.Tensor, owner: torch.Tensor, f8_sel: torch.Tensor,
                          eps_sel: torch.Tensor, cfg: EncodeConfig, levels: int,
                          seed: int, emit_q: bool = True) -> OwnerCrush:
    """Plain PyTorch version of the crush kernel, on any device."""
    check_words(words, levels)
    check_owner_regions(words, owner, levels)
    return owner_crush_body(MortonBlocks(words, levels), owner, f8_sel, eps_sel, cfg, levels,
                            seed, emit_q)


def fit_levels_kernel(words: torch.Tensor, cfg: EncodeConfig, levels: int) -> FitLevels:
    """All-levels fit, merge test and owner select; see the module docstring.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel on the current stream or raises.
    """
    check_words(words, levels)
    if not words_on_card(words):
        return fit_levels_reference(words, cfg, levels)
    dev = words.device
    h, w = words.shape
    ch, nb = cfg.channels, layout.grid_for(h, w).num_blocks

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = FitLevels(cnt0=empty(nb), f8_sel=empty(nb, BLOCK_AREA), eps_sel=empty(6, ch, nb),
                    avg_sel=empty(ch, nb, dtype=torch.float32), owner=empty(nb),
                    stats_bits=empty(nb), reasons=empty(levels - 1, nb))
    launch.call(launch.library("encode_merged"), "limg_fit_levels", "fit_levels", dev,
                words.data_ptr(), h, w, ch, levels, cfg.num_factors, *(t.data_ptr() for t in out))
    return out._replace(f8_sel=out.f8_sel.t())


def owner_crush_kernel(words: torch.Tensor, owner: torch.Tensor, f8_sel: torch.Tensor,
                       eps_sel: torch.Tensor, cfg: EncodeConfig, levels: int, seed: int,
                       emit_q: bool = True) -> OwnerCrush:
    """Crush, dither and decode at each block's owner level; see the module
    docstring. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel on the current stream or raises.
    """
    check_words(words, levels)
    ch = cfg.channels
    nb = layout.grid_for(*words.shape).num_blocks
    for name, t, shape, dtype in (("owner", owner, (nb,), torch.int32),
                                  ("f8_sel", f8_sel, (BLOCK_AREA, nb), torch.int32),
                                  ("eps_sel", eps_sel, (6, ch, nb), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != words.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {words.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not words_on_card(words):
        return owner_crush_reference(words, owner, f8_sel, eps_sel, cfg, levels, seed, emit_q)
    dev = words.device
    h, w = words.shape
    # block-major: a block's 8 lanes read its rows of 8 contiguous words
    # (free when f8_sel is fit_levels_kernel's transposed view); every
    # buffer the kernel reads is held here until it is enqueued
    f8_bm = f8_sel.t().contiguous()
    owner, eps_sel = owner.contiguous(), eps_sel.contiguous()

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    shifts, dec, bpp = empty(3, nb), empty(nb, BLOCK_AREA), empty(nb)
    q = empty(nb, BLOCK_AREA) if emit_q else None
    dist, dist_blk = empty(nb, dtype=torch.float32), empty(nb, dtype=torch.float32)
    launch.call(launch.library("encode_merged"), "limg_owner_crush", "owner_crush", dev,
                words.data_ptr(), h, w, ch, levels,
                *launch.crush_args(cfg, dither_key(seed, cfg.dither_seed)),
                owner.data_ptr(), f8_bm.data_ptr(), eps_sel.data_ptr(),
                shifts.data_ptr(), None if q is None else q.data_ptr(), dec.data_ptr(),
                dist.data_ptr(), dist_blk.data_ptr(), bpp.data_ptr())
    return OwnerCrush(shifts=shifts, q=None if q is None else q.t(), dec=dec.t(),
                      dist=dist, dist_blk=dist_blk, bpp=bpp)
