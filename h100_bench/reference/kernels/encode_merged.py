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

Frozen copy for the benchmark's reference: every ``*_kernel`` name here
runs its plain version, on any device; no CUDA kernel is built or
launched. The text above describes the port's kernels those names
stand for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EncodeConfig, static_block_bits
from ..ops import layout
from ..ops.crush import find_shifts, force_dropped_axes
from ..ops.decode import decode_blocks
from ..ops.dither import dither_crush
from ..ops.error import weighted_error
from ..ops.factors import extract_factors, quantize_factors
from ..ops.fit import Decomposition, drop_decomposition_axes, fit_regions
from ..ops.match import match_decomps, reason_bits
from ..ops.morton import MortonOrder, morton_mask
from ..ops.reduce import GroupReducer, OwnerReducer, pairwise_tree
from .encode_fixed import _pack_decoded

# kernel launches since the last reset (read and reset by callers)
launches = {"fit_levels": 0, "owner_crush": 0}

MIN_LEVELS, MAX_LEVELS = 2, 4


class FitLevels(NamedTuple):
    cnt0: torch.Tensor
    f8_sel: torch.Tensor
    eps_sel: torch.Tensor
    avg_sel: torch.Tensor
    owner: torch.Tensor
    stats_bits: torch.Tensor
    reasons: torch.Tensor


class OwnerCrush(NamedTuple):
    shifts: torch.Tensor
    q: torch.Tensor | None
    dec: torch.Tensor
    dist: torch.Tensor
    dist_blk: torch.Tensor
    bpp: torch.Tensor


def _check_words(words: torch.Tensor, levels: int) -> None:
    if words.ndim != 2 or words.dtype != torch.int32:
        raise ValueError(f"words must be (H, W) int32, got {tuple(words.shape)} {words.dtype}")
    if not MIN_LEVELS <= levels <= MAX_LEVELS:
        raise ValueError(f"levels must be {MIN_LEVELS}-{MAX_LEVELS}, got {levels}")


def check_owner_regions(words: torch.Tensor, owner: torch.Tensor, levels: int) -> None:
    """Raise unless ``owner`` (NB,), in row-major block order, is a
    quadtree of regions as the fit writes it: levels 0 to ``levels`` - 1,
    and every block of a level-l region (its aligned 2^l x 2^l square of
    blocks, cut by the grid) owned at l. The crush kernels read a region's
    owner from any one of its blocks, so on any other map they and their
    plain versions would disagree."""
    grid = layout.grid_for(*words.shape)
    by, bx = grid.blocks_y, grid.blocks_x
    if tuple(owner.shape) != (by * bx,):
        raise ValueError(f"owner must be ({by * bx},), got {tuple(owner.shape)}")
    if owner.numel() and not (int(owner.min()) >= 0 and int(owner.max()) < levels):
        raise ValueError(f"owner levels must be 0-{levels - 1}")
    plane = owner.reshape(by, bx)
    for lvl in range(1, levels):
        s = 1 << lvl
        ys, xs = -(-by // s), -(-bx // s)
        at = (plane == lvl).to(torch.int8)
        # per square: is some block owned at lvl, and are all of them (the
        # blocks outside the grid pad the first with 0, the second with 1)
        some = torch.zeros((ys * s, xs * s), dtype=torch.int8, device=owner.device)
        every = torch.ones_like(some)
        some[:by, :bx] = at
        every[:by, :bx] = at
        some = some.reshape(ys, s, xs, s).amax(dim=(1, 3))
        every = every.reshape(ys, s, xs, s).amin(dim=(1, 3))
        if not torch.equal(some, every):
            raise ValueError(f"owner is not uniform over its level-{lvl} regions")


def _unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    return torch.stack([layout.unpack_plane(packed, c) for c in range(n)])


def _pack_factors(f8: torch.Tensor) -> torch.Tensor:
    return f8[0] | (f8[1] << 8) | (f8[2] << 16)


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
    plain bodies below take either.

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


def fit_levels_body(blocks, cfg: EncodeConfig, levels: int) -> FitLevels:
    """The fit kernels' function on ``blocks`` (``MortonBlocks`` or
    kernels/encode_natural.py ``NatBlocks``), whose reducers set the order
    of the float sums."""
    ch = cfg.channels
    px = _unpack(blocks.packed, ch)
    n, dev = px.shape[-1], px.device
    owner = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    counts, reasons, sel, prev = [], [], None, None
    for lvl in range(levels):
        d, count = fit_regions(px, blocks.mask, ch, blocks.group_reducer(lvl))
        f8 = _pack_factors(torch.stack(
            [q.to(torch.int32) for q in quantize_factors(*extract_factors(px, d, ch))]))
        d = drop_decomposition_axes(d, cfg.num_factors)
        if lvl == 0:
            sel = (f8, d)
        else:
            # each child region against its region's first child; empty
            # children (grid padding) match
            p_d, p_count = prev
            c0 = Decomposition(*(blocks.first_of(f, lvl) for f in p_d))
            m, stats = match_decomps(p_d, c0, ch)
            is_child0 = blocks.first_children(lvl)
            ok = is_child0 | m | (p_count <= 0) | (blocks.first_of(p_count, lvl) <= 0)
            alive = blocks.combine(alive & ok, lvl, torch.logical_and)
            owner = torch.where(alive, lvl, owner)
            reasons.append(blocks.combine(torch.where(is_child0, 0, reason_bits(stats)), lvl,
                                          torch.bitwise_or))
            # alive only ever shrinks, so the last level alive is the owner
            sel = (torch.where(alive, f8, sel[0]),
                   Decomposition(*(torch.where(alive, a, b) for a, b in zip(d, sel[1]))))
        counts.append(count)
        prev = (d, count)

    stats_bits = torch.zeros_like(owner)
    for lvl in range(levels):
        hit = blocks.leads(lvl) & (owner >= lvl) & (counts[lvl] > 0)
        stats_bits = stats_bits | (hit.to(torch.int32) << lvl)
    reason_rows = [torch.where(blocks.leads(lvl) & (counts[lvl] > 0), r, 0)
                   for lvl, r in enumerate(reasons, start=1)]
    f8_sel, d_sel = sel
    return FitLevels(
        cnt0=blocks.restore(counts[0]),
        f8_sel=blocks.restore_pixels(f8_sel),
        eps_sel=blocks.restore(torch.stack(list(d_sel[1:]))),
        avg_sel=blocks.restore(d_sel.avg),
        owner=blocks.restore(owner),
        stats_bits=blocks.restore(stats_bits),
        reasons=blocks.restore(torch.stack(reason_rows)),
    )


def owner_crush_body(blocks, owner: torch.Tensor, f8_sel: torch.Tensor, eps_sel: torch.Tensor,
                     cfg: EncodeConfig, levels: int, seed: int, emit_q: bool) -> OwnerCrush:
    """The crush kernels' function on ``blocks`` (see ``fit_levels_body``)."""
    ch = cfg.channels
    px = _unpack(blocks.packed, ch)
    mask_i = blocks.mask.to(torch.int32)
    red = blocks.owner_reducer(owner, levels)
    eps = blocks.embed(eps_sel)
    d = Decomposition(torch.zeros(eps.shape[1:], dtype=torch.float32, device=eps.device),
                      *eps.unbind(0))
    f8 = _unpack(blocks.embed_pixels(f8_sel), 3)
    shifts = force_dropped_axes(find_shifts(px, blocks.mask, f8, d, cfg, red)[0],
                                cfg.num_factors)
    q = dither_crush(f8, shifts, seed, cfg.dither_seed,
                     enabled=cfg.dithering and cfg.crush_bits, blocks=blocks.dither_blocks)
    dec = decode_blocks(q, shifts, d, ch)
    err = (weighted_error(dec, px) * mask_i).to(torch.float32)
    dist_blk = red.block_sum(err)
    count = red.sum(mask_i)
    s_eff = torch.clamp(shifts, max=8)
    fac_bits = (8 - s_eff[0]) * count + (8 - s_eff[1]) * count + (8 - s_eff[2]) * count
    bpp = torch.clamp((static_block_bits(ch) + fac_bits + count // 2)
                      // torch.clamp(count, min=1), max=0xFF)
    bpp = bpp * (mask_i.sum(dim=0) > 0)
    return OwnerCrush(
        shifts=blocks.restore(shifts),
        q=blocks.restore_pixels(_pack_factors(q)) if emit_q else None,
        dec=blocks.restore_pixels(_pack_decoded(dec, ch)),
        dist=blocks.restore(red.combine_sum(dist_blk)),
        dist_blk=blocks.restore(dist_blk),
        bpp=blocks.restore(bpp.to(torch.int32)),
    )


def fit_levels_reference(words: torch.Tensor, cfg: EncodeConfig, levels: int) -> FitLevels:
    """Plain PyTorch version of the fit kernel, on any device."""
    _check_words(words, levels)
    return fit_levels_body(MortonBlocks(words, levels), cfg, levels)


def owner_crush_reference(words: torch.Tensor, owner: torch.Tensor, f8_sel: torch.Tensor,
                          eps_sel: torch.Tensor, cfg: EncodeConfig, levels: int,
                          seed: int, emit_q: bool = True) -> OwnerCrush:
    """Plain PyTorch version of the crush kernel, on any device."""
    _check_words(words, levels)
    check_owner_regions(words, owner, levels)
    return owner_crush_body(MortonBlocks(words, levels), owner, f8_sel, eps_sel, cfg, levels,
                            seed, emit_q)


def fit_levels_kernel(words: torch.Tensor, cfg: EncodeConfig, levels: int) -> FitLevels:
    """The plain version on every device."""
    return fit_levels_reference(words, cfg, levels)


def owner_crush_kernel(words: torch.Tensor, owner: torch.Tensor, f8_sel: torch.Tensor,
                       eps_sel: torch.Tensor, cfg: EncodeConfig, levels: int, seed: int,
                       emit_q: bool = True) -> OwnerCrush:
    """The plain version on every device."""
    return owner_crush_reference(words, owner, f8_sel, eps_sel, cfg, levels, seed, emit_q)


