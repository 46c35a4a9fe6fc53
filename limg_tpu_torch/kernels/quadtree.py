"""What the two quadtree wrappers share: the Morton pair's
(kernels/encode_merged.py) and the natural pair's
(kernels/encode_natural.py).

- the levels the kernels take (``MIN_LEVELS``-``MAX_LEVELS``) and their
  outputs (``FitLevels``, ``OwnerCrush``);
- the input checks: the word image (``check_words``), the owner map
  (``check_owner_regions``) and ``words_on_card``, the device rule of
  kernels/launch.py for a word image, which the kernels take contiguous;
- the plain versions' bodies, ``fit_levels_body`` and ``owner_crush_body``,
  which run the kernels' function on either pair's block order (the
  wrappers' ``MortonBlocks`` and ``NatBlocks``), whose reducers set the
  order of the float sums.
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
from . import launch

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


def check_words(words: torch.Tensor, levels: int) -> None:
    """Raise unless ``words`` is (H, W) int32 and ``levels`` is
    MIN_LEVELS-MAX_LEVELS."""
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


def words_on_card(words: torch.Tensor) -> bool:
    """``launch.on_card`` of the words, which the kernels take contiguous."""
    if not launch.on_card(words.device):
        return False
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    return True


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
        dec=blocks.restore_pixels(launch.pack_decoded(dec, ch)),
        dist=blocks.restore(red.combine_sum(dist_blk)),
        dist_blk=blocks.restore(dist_blk),
        bpp=blocks.restore(bpp.to(torch.int32)),
    )
