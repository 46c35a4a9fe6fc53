"""Quadtree-merged encoder, fused and dense paths, match and RD policies,
with run coalescing.

The counterpart of the JAX package's fused merged encode
(limg_tpu/regions.py: ``_fused_pre_body`` :1182, ``_fused_finish_body``
:1393, ``encode_image_merged_fused_device`` :1544, ``fused_merged_pre`` /
``fused_merged_finish`` :1589-1616, ``encode_image_merged`` :1828) and of
its fused RD path (``_rd_pre_body`` :1619, ``encode_image_merged_rd_device``
:1763, ``fused_rd_pre`` / ``fused_rd_finish`` :1791-1815), and of its dense
path (``encode_levels`` :173, ``merge_levels_alive`` :63,
``coalesce_level_bands`` :522, ``encode_image_merged_device`` :903).

Match policy (the default): every quadtree level is fitted, each parent
merges when all four children are alive and match its first child, every
block is crushed once at its owner level (two kernels,
kernels/encode_merged.py).

RD policy (``merge_policy="rd"``): every level is encoded on its own, 8x8
blocks and 16x16, 32x32, 64x64 pixel regions, by the region encode kernel
(kernels/encode_fixed.py), and a parent is kept when its bits + lambda *
distortion do not exceed its children's best (``rd_merge_keep``); each
level-0 block then takes the rows and planes of its owner level.

Both pre stages give one state, which one finish reads: run coalescing,
the JAX default. Matching neighbour regions of each level link into
horizontal runs, vertical runs and rectangles (``build_runs``, on the match
kernels), the run blocks are compacted into a buffer sorted by segment,
each segment is refitted and re-encoded as one region (the segment kernel),
and a run is kept when it does not cost more bits (match) or more bits +
lambda * distortion (RD) than its blocks did (``coalesce_segments``,
kernels/coalesce.py). On a CUDA device these are hand-written kernels; on
the CPU their plain versions.

The match policy's fit and crush run in one of two layouts
(``fused_layout``): "morton" (the default; kernels/encode_merged.py) or
"natural" (kernels/encode_natural.py, the JAX package's
pallas_kernels/encode_natural.py), whose kernels sum each block in the
natural layout's order and write the factor and decoded planes in the
image's own row-major layout; without coalescing the decoded plane is the
decoded image. The RD policy has one layout, as in the JAX package.

The port keeps every per-block plane in row-major block order, so the JAX
package's Morton lane relayouts (``mpos``, ``embed_rows``) and
``_stride_take`` have no counterpart here. ``return_state=True`` adds the
LTP1 serializer's state of the encode (limg_tpu/regions.py:1520-1535,
:2024-2035), for both policies and both layouts.

The dense path (``encode_image_merged_device``; ``encode_image_merged``
with ``fused=False``, and always at ``num_levels=1``, the fixed grid the
LTP1 stream of ``--fixed-grid`` holds) encodes every level on its own
through the region encode, as the RD policy does, and keeps each level's
rows and planes: a parent merges when its four children are alive and
match its first child (match policy, ``merge_levels_alive``) or by the RD
cut; each level's regions that own their pixels coalesce into runs on the
level's own grid (``coalesce_level_bands``: the match kernels, run
building, the segment kernel at the level's P = 64 * 4^l); each pixel
takes its owner level's decode. It takes any ``num_levels >= 1``, and is
the one path at 5 levels or more (128x128 pixel regions and larger), as in
the JAX package, whose fused path stops at 4 (``MAX_FUSED_LEVELS``); a
level whose regions are larger than the image is a grid of one or two.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import BLOCK_SIZE, EncodeConfig, static_block_bits
from .encoder import _as_image_tensor, resolve_device
from .kernels.coalesce import (ScanProblem, match_neighbors_kernel, match_pairs_kernel,
                               seg_scan, segment_encode_composed, segment_encode_kernel)
from .kernels.encode_fixed import encode_blocks_kernel
from .kernels.encode_merged import fit_levels_kernel, owner_crush_kernel
from .kernels.encode_natural import fit_levels_natural_kernel, owner_crush_natural_kernel
from .kernels.quadtree import MAX_LEVELS, MIN_LEVELS
from .ops import layout
from .ops.dither import coalesce_key
from .ops.error import max_possible_error
from .ops.fit import Decomposition
from .ops.match import MATCH_REASON_BITS, match_decomps
from .ops.segments import SEG_CAP
from .utils.diagnostics import count, span

MERGE_POLICIES = ("match", "rd")
FUSED_LAYOUTS = ("morton", "natural")

# level grids of this many blocks or more take the neighbour-match kernel;
# smaller ones are paired into one match_pairs launch (limg_tpu/regions.py:298)
NEIGHBOR_KERNEL_MIN_BLOCKS = 16384


def _check_levels(num_levels: int, merge_policy: str) -> None:
    if merge_policy not in MERGE_POLICIES:
        raise ValueError(f"merge_policy must be one of {MERGE_POLICIES}, got {merge_policy!r}")
    if num_levels < 1:
        raise ValueError(f"num_levels must be at least 1, got {num_levels}")


def _check_supported(num_levels: int, merge_policy: str, fused_layout: str) -> None:
    """The fused path's arguments: 2-4 levels, a known policy and layout."""
    _check_levels(num_levels, merge_policy)
    if not MIN_LEVELS <= num_levels <= MAX_LEVELS:
        raise ValueError(f"the fused path takes {MIN_LEVELS}-{MAX_LEVELS} levels, got "
                         f"num_levels={num_levels}: take the dense path (fused=False)")
    if fused_layout not in FUSED_LAYOUTS:
        raise ValueError(f"fused_layout must be one of {FUSED_LAYOUTS}, got {fused_layout!r}")


def _words(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3|4) uint8 -> (H, W) int32 words, R lowest; RGB gets alpha 0."""
    if image.shape[2] == 3:
        image = torch.nn.functional.pad(image, (0, 1))
    return layout.packed_words(image).contiguous()


def _leaders(owner0: torch.Tensor, grid: layout.BlockGrid, num_levels: int):
    """Row-major index of each block's region leader (the top-left block of
    its owner-level square)."""
    dev = owner0.device
    yy = torch.arange(grid.blocks_y, device=dev)[:, None]
    xx = torch.arange(grid.blocks_x, device=dev)[None, :]
    lead0 = (yy * grid.blocks_x + xx).reshape(-1)
    for lvl in range(1, num_levels):
        lp = (((yy >> lvl) << lvl) * grid.blocks_x + ((xx >> lvl) << lvl)).reshape(-1)
        lead0 = torch.where(owner0 == lvl, lp, lead0)
    return lead0.to(torch.int32)


# ---------------------------------------------------------------------------
# The RD policy's levels and cut (limg_tpu/regions.py:40-250)
# ---------------------------------------------------------------------------

def _child_indices(by: int, bx: int, device):
    """Flat child indices and validity for each parent of a (by, bx) grid:
    (idx (4, NP) int64 clipped in range, valid (4, NP) bool), NP =
    ceil(by/2) * ceil(bx/2), children (0,0), (0,1), (1,0), (1,1)."""
    iy = torch.arange(-(-by // 2), device=device)[:, None] * 2
    ix = torch.arange(-(-bx // 2), device=device)[None, :] * 2
    idx, valid = [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        cy, cx = iy + dy, ix + dx
        valid.append(((cy < by) & (cx < bx)).reshape(-1))
        idx.append((cy.clamp(max=by - 1) * bx + cx.clamp(max=bx - 1)).reshape(-1))
    return torch.stack(idx), torch.stack(valid)


def _owner_level(keep, grids, num_levels: int) -> torch.Tensor:
    """Per level-0 block: the highest level whose ancestor square is kept."""
    by0, bx0 = grids[0].blocks_y, grids[0].blocks_x
    dev = keep[0].device
    yy = torch.arange(by0, device=dev)[:, None]
    xx = torch.arange(bx0, device=dev)[None, :]
    owner = torch.zeros(by0 * bx0, dtype=torch.int32, device=dev)
    for lvl in range(1, num_levels):
        anc = ((yy >> lvl) * grids[lvl].blocks_x + (xx >> lvl)).reshape(-1)
        owner = torch.where(keep[lvl][anc], lvl, owner)
    return owner


def _q_level_to_block0(q: torch.Tensor, grid_l: layout.BlockGrid, grid0: layout.BlockGrid,
                       lvl: int) -> torch.Tensor:
    """(P_L, NB_L) pixel plane of level L -> (64, NB0) in level-0 blocks: a
    reshape and permute (pixel p of a level-L region splits as (yb, iy, xb,
    ix), the 8x8 sub-block (yb, xb) becoming a level-0 block), cropped to
    the level-0 grid."""
    s = 1 << lvl
    by_l, bx_l = grid_l.blocks_y, grid_l.blocks_x
    t = q.reshape(s, BLOCK_SIZE, s, BLOCK_SIZE, by_l, bx_l).permute(1, 3, 4, 0, 5, 2)
    t = t.reshape(BLOCK_SIZE * BLOCK_SIZE, by_l * s, bx_l * s)[:, :grid0.blocks_y, :grid0.blocks_x]
    return t.reshape(BLOCK_SIZE * BLOCK_SIZE, grid0.num_blocks)


def _encode_level(words: torch.Tensor, lvl: int, cfg: EncodeConfig, seed: int) -> dict:
    """One level's regions (8x8 px at level 0, 16x16 px at 1, ...) through
    the region encode, with each region's pixel count, bits (the
    reference's estimate: static header + factor bits,
    src/limg.cpp:1629-1636) and bpp (the bits over the pixels, rounded, at
    most 255), and the level's (P, NB) word and mask planes."""
    packed, mask, grid = layout.blockify_words(words, BLOCK_SIZE << lvl)
    shifts, q, dec, dist, *eps_avg = encode_blocks_kernel(packed, mask, cfg, seed,
                                                          emit_endpoints=True)
    count = mask.sum(dim=0, dtype=torch.int32)
    s_eff = torch.clamp(shifts, max=8)
    bits = static_block_bits(cfg.channels) + ((8 - s_eff) * count[None]).sum(
        dim=0, dtype=torch.int32)
    bpp = torch.clamp((bits + count // 2) // torch.clamp(count, min=1), max=0xFF)
    return dict(grid=grid, shifts=shifts, q=q, dec=dec, dist=dist[0], bits=bits, bpp=bpp,
                count=count, eps=torch.stack(eps_avg[:6]), avg=eps_avg[6], px=packed, mask=mask)


def encode_levels(words: torch.Tensor, cfg: EncodeConfig, seed: int, num_levels: int):
    """Every level through the region encode (limg_tpu/regions.py:173):
    (grids, per level the dict of ``_encode_level``). Level l's dither key
    is ``ops.dither.level_key(seed, cfg.dither_seed, l)``."""
    grids, levels = [], []
    for lvl in range(num_levels):
        with span(f"limg.dense.encode.L{lvl}"):
            lv = _encode_level(words, lvl, cfg, seed)
        grids.append(lv.pop("grid"))
        levels.append(lv)
    return grids, levels


def _decomp(lv: dict, idx) -> Decomposition:
    """A level's Decomposition at the columns ``idx``."""
    return Decomposition(*(f[:, idx] for f in (lv["avg"], *lv["eps"])))


def merge_levels_alive(levels, grids, channels: int):
    """The match policy's merges, bottom up (limg_tpu/regions.py:63): a
    level-L region is alive when its four children exist, are alive, and
    child 0 matches each of children 1-3 (ops/match.py ``match_decomps``,
    child 0 as its first argument).
    Returns (alive per level (NB_L,) bool, level 0 all True; per level
    1.. a dict of reason counts, each the blocks for which any of the three
    tests gave that reason)."""
    dev = levels[0]["avg"].device
    alive = [torch.ones(grids[0].num_blocks, dtype=torch.bool, device=dev)]
    stats = []
    for lvl in range(1, len(grids)):
        idx, valid = _child_indices(grids[lvl - 1].blocks_y, grids[lvl - 1].blocks_x, dev)
        kids = [_decomp(levels[lvl - 1], idx[k]) for k in range(4)]
        tests = [match_decomps(kids[0], kids[k], channels) for k in (1, 2, 3)]
        ok = valid.all(dim=0) & alive[lvl - 1][idx].all(dim=0)
        for m, _ in tests:
            ok = ok & m
        alive.append(ok)
        stats.append({k: (tests[0][1][k] | tests[1][1][k] | tests[2][1][k]).sum()
                      for k in tests[0][1]})
    return alive, stats


def rd_merge_keep(levels, grids, num_levels: int, lam, extra_header_bits: float = 0.0):
    """The rate-distortion quadtree cut, bottom up: a region costs its bits
    + ``extra_header_bits`` + lam * its distortion, and a parent is kept
    when all four children exist and its cost does not exceed the sum of
    the children's best costs (out-of-range children count 0), summed as a
    left fold over the children (0,0), (0,1), (1,0), (1,1).

    ``levels``: per level a dict with ``bits`` (NB_L,) int and ``dist``
    (NB_L,) float32; ``lam``: a float or float32 0-d tensor. Returns (keep
    per level (NB_L,) bool, level 0 all True; per level 1.. a dict of
    ``kept``, ``rd_cost_saved`` (float32 sum of child cost - own cost over
    kept parents) and ``cost_reject`` (parents with four children left
    split)).
    """
    dev = levels[0]["dist"].device
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)

    def cost_of(lv):
        return lv["bits"].to(torch.float32) + extra_header_bits + lam * lv["dist"]

    best = [cost_of(levels[0])]
    keep = [torch.ones_like(best[0], dtype=torch.bool)]
    stats = []
    for lvl in range(1, num_levels):
        idx, valid = _child_indices(grids[lvl - 1].blocks_y, grids[lvl - 1].blocks_x, dev)
        kids = torch.where(valid, best[lvl - 1][idx], 0.0)
        child_best = ((kids[0] + kids[1]) + kids[2]) + kids[3]
        own = cost_of(levels[lvl])
        complete = valid.all(dim=0)
        merged = complete & (own <= child_best)
        keep.append(merged)
        best.append(torch.where(merged, own, child_best))
        stats.append(dict(kept=merged.sum(),
                          rd_cost_saved=torch.where(merged, child_best - own, 0.0).sum(),
                          cost_reject=(~merged & complete).sum()))
    return keep, stats


# ---------------------------------------------------------------------------
# Run building (limg_tpu/regions.py:137, :260-519, :1100-1158)
# ---------------------------------------------------------------------------

def neighbor_pair_matches(rows_per_level, grids, channels: int):
    """Right and down neighbour matches of every level.

    ``rows_per_level``: (7ch, gy*gx) float32 stacks (Decomposition field
    order) per level. Level grids of NEIGHBOR_KERNEL_MIN_BLOCKS blocks or
    more go through the neighbour kernel; the pairs of all smaller levels
    and both directions are concatenated into one match_pairs launch.
    Returns [(m_left (gy, gx-1) | None, m_up (gy-1, gx) | None)] per
    level, with a the +1 neighbour and b the block itself.
    """
    n = 7 * channels
    out = [None] * len(grids)
    parts_a, parts_b, flat = [], [], []
    for li, (rows, grid) in enumerate(zip(rows_per_level, grids)):
        gy, gx = grid.blocks_y, grid.blocks_x
        plane = rows.reshape(n, gy, gx)
        if gy * gx >= NEIGHBOR_KERNEL_MIN_BLOCKS:
            m_right, m_down = match_neighbors_kernel(plane, channels)
            out[li] = (m_right[:, :gx - 1] if gx > 1 else None,
                       m_down[:gy - 1] if gy > 1 else None)
            continue
        flat.append(li)
        if gx > 1:
            parts_a.append(plane[:, :, 1:].reshape(n, -1))
            parts_b.append(plane[:, :, :-1].reshape(n, -1))
        if gy > 1:
            parts_a.append(plane[:, 1:].reshape(n, -1))
            parts_b.append(plane[:, :-1].reshape(n, -1))
    if parts_a:
        m = match_pairs_kernel(torch.cat(parts_a, dim=-1), torch.cat(parts_b, dim=-1),
                               channels)
        off = 0
        for li in flat:
            gy, gx = grids[li].blocks_y, grids[li].blocks_x
            pair = []
            for size, shape in ((gy * (gx - 1), (gy, gx - 1)), ((gy - 1) * gx, (gy - 1, gx))):
                pair.append(m[off:off + size].reshape(shape) if size else None)
                off += size
            out[li] = tuple(pair)
    else:
        for li in flat:
            out[li] = (None, None)
    return out


def _horizontal_segments(owned: torch.Tensor, grid: layout.BlockGrid, max_members: int,
                         matches) -> torch.Tensor:
    """(gy, gx) int32 ids of the horizontal runs of one level: owned cells
    linked left to a matching owned neighbour, at most ``max_members``
    columns apart; each id is the run's first cell's flat index."""
    gy, gx = grid.blocks_y, grid.blocks_x
    dev = owned.device
    idx2 = torch.arange(gy * gx, dtype=torch.int32, device=dev).reshape(gy, gx)
    if gx == 1:
        return idx2
    own2 = owned.reshape(gy, gx)
    link_left = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
    link_left[:, 1:] = matches[0] & own2[:, 1:] & own2[:, :-1]
    link_left &= (torch.arange(gx, device=dev) % max_members != 0)[None, :]
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    return torch.cummax(torch.where(link_left, neg, idx2), dim=1).values


def build_runs_levels(levels) -> list:
    """Link the owned cells of each level into runs of matching neighbours.

    Horizontal runs link left, horizontal singletons link up into vertical
    runs, and equal-span horizontal runs stack into rectangles when every
    vertical pair matches (limg_tpu/regions.py:376 ``build_runs``, per
    level). ``levels``: (owned (NB,) bool, grid, max_members, matches: the
    level's (m_left, m_up) from ``neighbor_pair_matches``) per level. The
    segment scans go stage by stage across all levels, each stage one
    ``seg_scan`` launch: every level's horizontal run lengths and rectangle
    test (the AND of the vertical matches over a horizontal run is a
    segment min), then every level's vertical run lengths, scanned down the
    columns of the (gy, gx) map in place. Returns [(seg_id (NB,) int32, the
    run's first cell's flat index; run_len (NB,) int32 per cell)] per
    level.
    """
    st = []
    for owned, grid, max_members, matches in levels:
        max_members = max(2, max_members)
        rw_cap = min(16, max(2, int(max_members ** 0.5)))
        st.append(dict(owned=owned, gy=grid.blocks_y, gx=grid.blocks_x,
                       max_members=max_members, rw_cap=rw_cap,
                       rh_cap=max(1, max_members // rw_cap), matches=matches,
                       seg_h2=_horizontal_segments(owned, grid, max_members, matches)))

    # stage 1: horizontal run lengths, and the rectangle test's vertical AND
    problems, users = [], []
    for s in st:
        gy, gx = s["gy"], s["gx"]
        if gx == 1:
            continue
        rows, ops = [None], "s"
        if gy > 1:
            vmatch = torch.zeros((gy, gx), dtype=torch.int32, device=s["owned"].device)
            vmatch[1:] = s["matches"][1].to(torch.int32)
            rows.append(vmatch.reshape(-1))
            ops += "n"
        problems.append(ScanProblem(s["seg_h2"].reshape(-1), rows, ops, 1))
        users.append(s)
    for s, out in zip(users, seg_scan(problems)):
        s["len_h"] = out[0]
        s["vand"] = out[1].reshape(s["gy"], s["gx"]) if out.shape[0] > 1 else None
    for s in st:
        if s["gx"] == 1:
            s["len_h"] = torch.ones(s["gy"], dtype=torch.int32, device=s["owned"].device)
            s["vand"] = None

    # stage 2: vertical runs of horizontal singletons, their lengths down
    # the columns (the ids stay row-major flat indices: a scan only
    # compares them)
    problems, users = [], []
    for s in st:
        gy, gx = s["gy"], s["gx"]
        if gy == 1:
            continue
        elig2 = (s["owned"] & (s["len_h"] == 1)).reshape(gy, gx)
        link_up = torch.zeros((gy, gx), dtype=torch.bool, device=elig2.device)
        link_up[1:] = s["matches"][1] & elig2[1:] & elig2[:-1]
        link_up &= (torch.arange(gy, device=elig2.device) % s["max_members"] != 0)[:, None]
        idx2 = torch.arange(gy * gx, dtype=torch.int32, device=elig2.device).reshape(gy, gx)
        neg = torch.full((), -1, dtype=torch.int32, device=elig2.device)
        s["seg_v2"] = torch.cummax(torch.where(link_up, neg, idx2), dim=0).values
        s["elig"] = elig2.reshape(-1)
        problems.append(ScanProblem(s["seg_v2"], [None], "s", columns=True))
        users.append(s)
    for s, out in zip(users, seg_scan(problems)):
        s["len_v"] = out[0].reshape(-1)

    return [_finish_runs(s) for s in st]


def _finish_runs(s: dict):
    """One level's (seg_id, run_len) from its scanned stages: vertical runs
    of horizontal singletons, then rectangles of stacked equal-span
    horizontal runs."""
    gy, gx, own2 = s["gy"], s["gx"], s["owned"].reshape(s["gy"], s["gx"])
    seg_h2, len_h = s["seg_h2"], s["len_h"]
    seg_h = seg_h2.reshape(-1)
    dev = seg_h.device
    if gy > 1:
        elig = s["elig"]
        seg_id = torch.where(elig, s["seg_v2"].reshape(-1), seg_h)
        run_len = torch.where(elig, s["len_v"], len_h)
    else:
        seg_id, run_len = seg_h, len_h
    if gy > 1 and gx > 1:
        len_h2 = len_h.reshape(gy, gx)
        is_hrun = own2 & (len_h2 >= 2) & (len_h2 <= s["rw_cap"])
        same_span = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
        same_span[1:] = (seg_h2[1:] - gx == seg_h2[:-1]) & (len_h2[1:] == len_h2[:-1])
        hrun_above = torch.zeros_like(is_hrun)
        hrun_above[1:] = is_hrun[:-1]
        link_rect = (same_span & (s["vand"] > 0) & is_hrun & hrun_above
                     & (torch.arange(gy, device=dev) % s["rh_cap"] != 0)[:, None])
        yy = torch.arange(gy, dtype=torch.int32, device=dev)[:, None].expand(gy, gx)
        neg = torch.full((), -1, dtype=torch.int32, device=dev)
        r0 = torch.cummax(torch.where(link_rect, neg, yy), dim=0).values
        linked_below = torch.zeros_like(link_rect)
        linked_below[:-1] = link_rect[1:]
        r1 = torch.cummin(torch.where(linked_below, gy, yy).flip(0), dim=0).values.flip(0)
        rows_total = r1 - r0 + 1
        rect_id = r0 * gx + (seg_h2 - yy * gx)
        in_rect = (is_hrun & (rows_total >= 2)).reshape(-1)
        seg_id = torch.where(in_rect, rect_id.reshape(-1), seg_id)
        run_len = torch.where(in_rect, (rows_total * len_h2).reshape(-1), run_len)
    return seg_id.to(torch.int32), run_len.to(torch.int32)


def build_runs(owned: torch.Tensor, grid: layout.BlockGrid, max_members: int, matches):
    """``build_runs_levels`` for one level: (seg_id, run_len)."""
    return build_runs_levels([(owned, grid, max_members, matches)])[0]


def _bcast0(v: torch.Tensor, grid_l: layout.BlockGrid, grid0: layout.BlockGrid, lvl: int):
    """Per-level-L values (..., NB_L) -> (..., NB0), repeated over each
    level-0 block of the square and cropped to the level-0 grid."""
    s = 1 << lvl
    t = v.reshape(*v.shape[:-1], grid_l.blocks_y, grid_l.blocks_x)
    t = t.repeat_interleave(s, dim=-2).repeat_interleave(s, dim=-1)
    t = t[..., :grid0.blocks_y, :grid0.blocks_x]
    return t.reshape(*v.shape[:-1], grid0.num_blocks)


def build_runs_multilevel(owner0, avg0, eps0, lead0, grid0: layout.BlockGrid,
                          num_levels: int, channels: int):
    """Run building at every quadtree level, as a level-0 segment map.

    Level L links the regions it owns, read from the owner-selected rows
    at the top-left block of each level-L square; a level-L run's level-0
    blocks all take the id of the run's first square's leader block.
    ``avg0`` (ch, NB) float32 and ``eps0`` (6, ch, NB) int32 are the
    owner-selected rows. Returns (seg0 (NB,) int32, is_run0 (NB,) bool).
    """
    by0, bx0, nb = grid0.blocks_y, grid0.blocks_x, grid0.num_blocks
    n = 7 * channels
    rows0 = torch.cat([avg0.to(torch.float32), eps0.reshape(6 * channels, nb).to(torch.float32)])
    plane0 = rows0.reshape(n, by0, bx0)
    owner2 = owner0.reshape(by0, bx0)
    grids, owned, rows = [], [], []
    for lvl in range(num_levels):
        s = 1 << lvl
        grids.append(layout.grid_for(grid0.height, grid0.width, BLOCK_SIZE << lvl))
        owned.append((owner2[::s, ::s] == lvl).reshape(-1))
        rows.append(plane0[:, ::s, ::s].reshape(n, -1) if lvl else rows0)
    matches = neighbor_pair_matches(rows, grids, channels)
    runs = build_runs_levels([(owned[lvl], grids[lvl], SEG_CAP >> (2 * lvl), matches[lvl])
                              for lvl in range(num_levels)])
    seg0 = lead0
    is_run0 = torch.zeros(nb, dtype=torch.bool, device=owner0.device)
    for lvl, (seg_l, len_l) in enumerate(runs):
        is_run_l = owned[lvl] & (len_l >= 2)
        if lvl == 0:
            take = is_run_l & (owner0 == 0)
            seg0 = torch.where(take, seg_l, seg0)
        else:
            bxl = grids[lvl].blocks_x
            lead0_of = ((seg_l // bxl) << lvl) * bx0 + ((seg_l % bxl) << lvl)
            take = (owner0 == lvl) & _bcast0(is_run_l, grids[lvl], grid0, lvl)
            seg0 = torch.where(take, _bcast0(lead0_of, grids[lvl], grid0, lvl), seg0)
        is_run0 = is_run0 | take
    return seg0.to(torch.int32), is_run0


# ---------------------------------------------------------------------------
# Run coalescing (limg_tpu/regions.py:559-894, :1161, :1818)
# ---------------------------------------------------------------------------

def _coalesce_cap(cap_frac: int, nb: int) -> int:
    """The run buffer's member capacity at the device layer: < 0 pins
    min(nb, -cap_frac); <= 1 (0 included) or a small grid is full
    capacity; > 1 is nb // cap_frac, at least 4096."""
    if cap_frac < 0:
        return min(nb, -cap_frac)
    if cap_frac <= 1 or nb <= 4096:
        return nb
    return max(4096, nb // cap_frac)


def auto_run_capacity(n_run_blocks: int, nb: int) -> int:
    """The smallest power-of-two capacity (at least 4096) holding every run
    block, at most nb."""
    if n_run_blocks <= 0:
        return min(nb, 4096)
    return min(nb, max(4096, 1 << (int(n_run_blocks) - 1).bit_length()))


def compact_runs(seg_id: torch.Tensor, is_run: torch.Tensor, cap: int):
    """The run buffer's order: blocks sorted by (is_run, seg_id), stably, so
    each segment's members are contiguous and runs come first. Returns
    (order (NB,) int64, seg_c (cap,) int32: each of the first ``cap``
    lanes' segment id, the position of the segment's first lane)."""
    order = torch.argsort(torch.where(is_run, seg_id, 2 ** 30), stable=True)
    seg_orig = seg_id[order[:cap]]
    is_seg_start = torch.ones(seg_orig.shape[0], dtype=torch.bool, device=seg_id.device)
    is_seg_start[1:] = seg_orig[1:] != seg_orig[:-1]
    pos = torch.arange(seg_orig.shape[0], dtype=torch.int32, device=seg_id.device)
    seg_c = torch.cummax(torch.where(is_seg_start, pos, -1), dim=0).values
    return order, seg_c.to(torch.int32)


def coalesce_segments(px_plane, mask_plane, seg_id, is_run, lv: dict, cfg: EncodeConfig,
                      key: int, cap: int, need_planes: bool, merge_policy: str = "match",
                      rd_lambda=0.0, header_bits: int | None = None,
                      use_kernel: bool | None = None, old_header_included: bool = True):
    """Re-encode the run blocks grouped by ``seg_id`` and write back the
    runs that do not cost more: more bits (match policy), or more bits +
    ``rd_lambda`` * distortion (RD policy).

    ``px_plane`` / ``mask_plane``: (P, NB) int32 words / bool of every
    block, a block an 8x8 block (P = 64) or a dense level's region of P =
    64 * 4^l pixels; ``lv``: the per-block rows of the encode
    (``shifts`` (3, NB), ``bits``, ``bpp``, ``dist`` (a region's on its
    leader under the fused RD policy), ``eps`` (6, ch, NB), ``avg`` (ch,
    NB), ``dec`` and ``q`` (P, NB) planes), updated in place.
    ``header_bits`` is a refitted run's header (None: the static estimate).
    With ``old_header_included`` (the fused stages) ``lv["bits"]`` already
    carries that header on region leaders only; without it (the dense
    levels, limg_tpu/regions.py:660-667) each block carries one static
    estimate, and its old bits take ``header_bits`` less that estimate
    before they are weighed. The run blocks are
    sorted by (is_run, seg_id), so each segment is contiguous, and the first
    ``cap`` go into the buffer; the one segment the capacity cut splits is
    reverted and counted. ``use_kernel`` picks the re-encode: the segment
    kernel (True, and the default None; a CPU tensor takes its plain
    version), or its composition of ops (False; kernels/coalesce.py
    ``segment_encode_composed``, the JAX package's jnp branch,
    limg_tpu/regions.py:737-772), bit-equal to it. Returns (applied (NB,)
    bool, n_runs, coalesce_stats).
    """
    ch = cfg.channels
    nb, dev = seg_id.shape[0], seg_id.device
    cap = min(nb, cap)
    order, seg_c = compact_runs(seg_id, is_run, cap)
    sel = order[:cap]
    seg_orig, sel_is_run = seg_id[sel], is_run[sel]
    old_bits_sel = lv["bits"][sel]
    if header_bits is not None and not old_header_included:
        old_bits_sel = old_bits_sel + (header_bits - static_block_bits(ch))
    packed_c = px_plane[:, sel]
    mask_c = mask_plane[:, sel] & sel_is_run[None]
    is_start = torch.arange(cap, dtype=torch.int32, device=dev) == seg_c

    # the capacity cut splits at most one segment: it reverts, and counts
    if cap < nb:
        first_excl = order[cap]
        split_seg = torch.where(is_run[first_excl], seg_id[first_excl], -1)
    else:
        split_seg = torch.full((), -1, dtype=torch.int32, device=dev)
    ok_c = sel_is_run & (seg_orig != split_seg)
    n_dropped = (is_start & sel_is_run & (seg_orig == split_seg)).sum()
    n_members = sel_is_run.sum()
    n_overflow = is_run.sum() - n_members
    # the buffer's lanes that hold a run member, of its lanes (segment_encode_p{P})
    count(f"limg.segments.members.p{px_plane.shape[0]}", n_members)
    count(f"limg.segments.lanes.p{px_plane.shape[0]}", cap)

    encode = segment_encode_composed if use_kernel is False else segment_encode_kernel
    enc = encode(packed_c, mask_c, seg_c, sel.to(torch.int32), cfg, key, emit_q=need_planes)
    s_eff = torch.clamp(enc.shifts, max=8)
    fac_bits_blk = ((8 - s_eff) * enc.count_blk[None]).sum(dim=0, dtype=torch.int32)
    header = static_block_bits(ch) if header_bits is None else header_bits
    bits_blk = fac_bits_blk + header * is_start.to(torch.int32)
    old_bits_masked = torch.where(sel_is_run, old_bits_sel, 0)
    # segment sums of the new and old bits, and under the RD policy of the
    # new distortion and the old RD cost: one scan launch
    problems = [ScanProblem(seg_c, (fac_bits_blk, old_bits_masked), "ss")]
    if merge_policy == "rd":
        lam = torch.as_tensor(rd_lambda, dtype=torch.float32, device=dev)
        old_cost = old_bits_sel.to(torch.float32) + lam * lv["dist"][sel]
        problems.append(ScanProblem(seg_c, (enc.dist_blk, torch.where(sel_is_run, old_cost, 0.0)),
                                    "ss"))
    sums = seg_scan(problems)
    bits_mem = sums[0][0] + header
    bpp_mem = torch.clamp((bits_mem + enc.count_mem // 2) // torch.clamp(enc.count_mem, min=1),
                          max=0xFF)
    if merge_policy == "rd":
        accept = ok_c & (bits_mem.to(torch.float32) + lam * sums[1][0] <= sums[1][1])
    else:
        accept = ok_c & (bits_mem <= sums[0][1])

    # write back: every buffer lane to its block, the accepted ones changed
    def put(dst, src):
        dst[..., sel] = torch.where(accept, src, dst[..., sel])

    put(lv["shifts"], enc.shifts)
    put(lv["bits"], bits_blk)
    put(lv["bpp"], bpp_mem.to(lv["bpp"].dtype))
    put(lv["dist"], enc.dist_blk)
    put(lv["dec"], enc.dec)
    if need_planes:
        put(lv["eps"], enc.eps)
        put(lv["avg"], enc.avg)
        put(lv["q"], enc.q)
    applied = torch.zeros(nb, dtype=torch.bool, device=dev)
    applied[sel] = accept
    stats = dict(
        dropped_runs_at_capacity=n_dropped,
        overflow_run_blocks=n_overflow,
        rejected_runs=(is_start & sel_is_run & ~accept).sum() - n_dropped,
    )
    return applied, (is_start & accept).sum(), stats


# ---------------------------------------------------------------------------
# The two stages
# ---------------------------------------------------------------------------

def _bits_with_header(shifts: torch.Tensor, cnt0: torch.Tensor, lead0: torch.Tensor,
                      header: int) -> torch.Tensor:
    """Per-block factor bits, plus the region header on each region's leader:
    what run coalescing weighs a refit against."""
    fac_bits0 = ((8 - torch.clamp(shifts, max=8)) * cnt0[None]).sum(dim=0, dtype=torch.int32)
    is_leader0 = lead0 == torch.arange(lead0.shape[0], device=lead0.device)
    return fac_bits0 + header * is_leader0.to(torch.int32)


def _pre_state(words: torch.Tensor, grid: layout.BlockGrid, lv0: dict, owner0, lead0, cnt0,
               stats_row, merge_stats, num_levels: int, channels: int, coalesce: bool) -> dict:
    """The state both pre stages hand to ``_fused_finish``: the owner-level
    rows and planes ``lv0`` (shifts, bits, bpp, dist, eps, avg, dec, q), the
    owner level, region leader and pixel count of each block, the stats row
    (bit l: a level-l-aligned block whose owner level is >= l), the merge
    stats, and with ``coalesce`` the runs and the level-0 pixel planes.
    ``dec_nat`` is the natural layout's decoded plane when ``lv0`` holds no
    block-major one; ``layout`` names the fit's and crush's layout."""
    state = dict(grid=grid, lv0=lv0, owner0=owner0, lead0=lead0, cnt0=cnt0,
                 stats_row=stats_row, merge_stats=merge_stats, seg0=None, is_run0=None,
                 n_run_blocks=torch.zeros((), dtype=torch.int64, device=lead0.device),
                 dec_nat=None, layout="morton")
    if coalesce:
        with span("limg.pre.runs"):
            seg0, is_run0 = build_runs_multilevel(owner0, lv0["avg"], lv0["eps"], lead0, grid,
                                                  num_levels, channels)
            px_plane, mask_plane, _ = layout.blockify_words(words)
        state.update(seg0=seg0, is_run0=is_run0, n_run_blocks=is_run0.sum(),
                     px=px_plane, mask=mask_plane)
    return state


def _fused_pre(img: torch.Tensor, cfg: EncodeConfig, seed: int, num_levels: int,
               need_q: bool, coalesce: bool, fused_layout: str = "morton"):
    """Match policy, stages A-E: fit every level, merge test and owner select
    (one kernel), crush at the owner level (one kernel), leaders and bits,
    and with ``coalesce`` run building. ``fused_layout="natural"`` runs the
    natural-layout kernels (limg_tpu/regions.py:1234-1278): their decoded
    plane is the image, blockified only for the coalesce pass's write-back,
    and their factor plane is blockified for the planes and the state."""
    ch = cfg.channels
    words = _words(img)
    grid = layout.grid_for(*words.shape)
    dec_nat = None
    natural = fused_layout == "natural"
    with span("limg.pre.fit"):
        fit = (fit_levels_natural_kernel if natural else fit_levels_kernel)(words, cfg,
                                                                             num_levels)
    with span("limg.pre.crush"):
        if natural:
            crush = owner_crush_natural_kernel(words, fit.owner, fit.f8_sel, fit.eps_sel, cfg,
                                               num_levels, seed, emit_q=need_q)
            if coalesce:
                dec = layout.blockify_words(crush.dec)[0]
            else:
                dec, dec_nat = None, crush.dec
            crush = crush._replace(dec=dec,
                                   q=layout.blockify_words(crush.q)[0] if need_q else None)
        else:
            crush = owner_crush_kernel(words, fit.owner, fit.f8_sel, fit.eps_sel, cfg,
                                       num_levels, seed, emit_q=need_q)
    with span("limg.pre.leaders"):
        merge_stats = [{name: (r & bit).ne(0).sum() for name, bit in MATCH_REASON_BITS}
                       for r in fit.reasons]
        lead0 = _leaders(fit.owner, grid, num_levels)
        lv0 = dict(shifts=crush.shifts,
                   bits=_bits_with_header(crush.shifts, fit.cnt0, lead0, static_block_bits(ch)),
                   bpp=crush.bpp, dist=crush.dist_blk, eps=fit.eps_sel, avg=fit.avg_sel,
                   dec=crush.dec, q=crush.q)
    state = _pre_state(words, grid, lv0, fit.owner, lead0, fit.cnt0, fit.stats_bits,
                       merge_stats, num_levels, ch, coalesce)
    state.update(dec_nat=dec_nat, layout=fused_layout)
    return state


def _rd_pre(img: torch.Tensor, cfg: EncodeConfig, seed: int, num_levels: int, need_q: bool,
            rd_lambda, header_bits: int | None, coalesce: bool):
    """RD policy, stages A-E (limg_tpu/regions.py:1619 ``_rd_pre_body``):
    every level through the region encode kernel, the RD cut, the owner
    level's rows and planes selected per level-0 block, leaders and bits,
    and with ``coalesce`` run building.

    A region's distortion is parked on its leader block (0 on the others),
    so that segment sums over whole regions give region sums; its bits
    carry ``header_bits`` (None: the static estimate) on the leader, while
    bpp keeps the static estimate over the region's pixels, as the JAX
    package reports it.
    """
    ch = cfg.channels
    words = _words(img)
    grid0 = layout.grid_for(*words.shape)
    dev = words.device
    grids, levels = encode_levels(words, cfg, seed, num_levels)
    hdr = static_block_bits(ch) if header_bits is None else header_bits
    keep, merge_stats = rd_merge_keep(levels, grids, num_levels, rd_lambda,
                                      float(hdr - static_block_bits(ch)))
    owner0 = _owner_level(keep, grids, num_levels)

    yy0 = torch.arange(grid0.blocks_y, device=dev)[:, None]
    xx0 = torch.arange(grid0.blocks_x, device=dev)[None, :]

    def aligned(lvl):
        """Level-0 blocks at the top-left of a level-``lvl`` square."""
        s = 1 << lvl
        return ((yy0 % s == 0) & (xx0 % s == 0)).reshape(-1)

    lv0 = levels[0]
    sel = {k: lv0[k] for k in ("shifts", "eps", "avg", "dec", "dist", "bits", "count")}
    sel["q"] = lv0["q"] if need_q else None
    for lvl in range(1, num_levels):
        lv, g = levels[lvl], grids[lvl]
        take = owner0 == lvl

        def b0(v, lvl=lvl, g=g):
            return _bcast0(v, g, grid0, lvl)

        for k in ("shifts", "eps", "avg", "bits", "count"):
            sel[k] = torch.where(take, b0(lv[k]), sel[k])
        sel["dec"] = torch.where(take, _q_level_to_block0(lv["dec"], g, grid0, lvl), sel["dec"])
        if need_q:
            sel["q"] = torch.where(take, _q_level_to_block0(lv["q"], g, grid0, lvl), sel["q"])
        sel["dist"] = torch.where(take, torch.where(aligned(lvl), b0(lv["dist"]), 0.0),
                                  sel["dist"])

    lead0 = _leaders(owner0, grid0, num_levels)
    cnt0 = lv0["count"]
    rbits, rcnt = sel["bits"], sel["count"]
    stats_row = torch.zeros(grid0.num_blocks, dtype=torch.int32, device=dev)
    for lvl in range(num_levels):
        stats_row |= torch.where(aligned(lvl) & (owner0 >= lvl), 1 << lvl, 0).to(torch.int32)
    state_lv0 = dict(
        shifts=sel["shifts"], bits=_bits_with_header(sel["shifts"], cnt0, lead0, hdr),
        bpp=torch.clamp((rbits + rcnt // 2) // torch.clamp(rcnt, min=1), max=0xFF),
        dist=sel["dist"], eps=sel["eps"], avg=sel["avg"], dec=sel["dec"], q=sel["q"])
    return _pre_state(words, grid0, state_lv0, owner0, lead0, cnt0, stats_row, merge_stats,
                      num_levels, ch, coalesce)


def _decoded_image(dec_packed: torch.Tensor | None, grid: layout.BlockGrid,
                   dec_nat: torch.Tensor | None = None) -> torch.Tensor:
    """(64, NB) packed decoded words, or without them the natural (H', W')
    plane ``dec_nat`` -> (H, W, 4) uint8."""
    if dec_packed is None:
        words = dec_nat[:grid.height, :grid.width]
    else:
        words = layout.unblockify(dec_packed[None], grid, BLOCK_SIZE)[..., 0]
    return words.contiguous().view(torch.uint8).reshape(grid.height, grid.width, 4)


def _fused_finish(state: dict, cfg: EncodeConfig, seed: int, num_levels: int,
                  emit_planes: bool, cap: int | None, merge_policy: str = "match",
                  rd_lambda=0.0, header_bits: int | None = None, return_state: bool = False):
    """Stages F-G of either policy: with a run capacity ``cap`` (None: no
    coalescing) the coalesce pass, then the stats as flat level-0 sums, the
    decoded image, with ``emit_planes`` the per-block planes, and with
    ``return_state`` the LTP1 serializer's state (limg_tpu/regions.py:
    1520-1535): ``ser_rows`` (6ch + 6, NB) int32 [owner level, 3 shifts,
    the 6ch endpoint rows, run region id, run applied] and ``ser_q`` (3, 64,
    NB) uint8 crushed factors."""
    need_q = emit_planes or return_state
    if need_q and state["lv0"]["q"] is None:
        raise ValueError("emit_planes and return_state need a state made with need_q=True")
    grid, lv = state["grid"], state["lv0"]
    nb, owner0, cnt0 = grid.num_blocks, state["owner0"], state["cnt0"]
    dev = cnt0.device
    n_runs = torch.zeros((), dtype=torch.int64, device=dev)
    coalesce_stats, rid_blk = {}, state["lead0"]
    # without coalescing, every block is its own run region, none applied
    run_rid = torch.arange(nb, dtype=torch.int32, device=dev)
    applied = torch.zeros(nb, dtype=torch.bool, device=dev)
    if cap is not None:
        with span("limg.finish.coalesce"):
            # the coalesce pass updates the rows in place: work on copies
            lv = {k: None if v is None else v.clone() for k, v in lv.items()}
            applied, n_runs, coalesce_stats = coalesce_segments(
                state["px"], state["mask"], state["seg0"], state["is_run0"], lv, cfg,
                coalesce_key(seed, cfg.dither_seed), cap, need_planes=need_q,
                merge_policy=merge_policy, rd_lambda=rd_lambda, header_bits=header_bits)
            rid_blk = torch.where(applied, state["seg0"], rid_blk)
            run_rid = torch.where(applied, state["seg0"], run_rid)
    with span("limg.finish.totals"):
        cnt0 = cnt0.to(torch.int64)
        s_eff0 = torch.clamp(lv["shifts"], max=8).to(torch.int64)
        one_hot = s_eff0[:, None, :] == torch.arange(9, device=dev)[None, :, None]
        out = dict(
            decoded=_decoded_image(lv["dec"], grid, state["dec_nat"]),
            accum_bits=((8 - s_eff0) * cnt0[None]).sum(dim=1),
            bits_histogram=(one_hot * cnt0[None, None, :]).sum(dim=2),
            alive_counts=torch.stack([((state["stats_row"] >> lvl) & 1).sum()
                                      for lvl in range(num_levels)]),
            mean_bpp=(lv["bpp"].to(torch.float64) * cnt0).sum() / (grid.height * grid.width),
            total_err=lv["dist"].to(torch.float64).sum(),
            merge_stats=state["merge_stats"],
            n_runs=n_runs,
            coalesce_stats=coalesce_stats,
        )
        if emit_planes:
            out["endpoint_rows"] = lv["eps"].reshape(-1, nb)
            out["block_rows8"] = torch.cat(
                [s_eff0, lv["bpp"][None].to(torch.int64),
                 owner0[None].to(torch.int64)]).to(torch.uint8)                  # (5, NB)
            out["region_rows"] = owner0 * nb + rid_blk
            q = torch.stack([(lv["q"] >> (8 * k)) & 0xFF for k in range(3)])
            out["factors_pnb"] = ((q << s_eff0[:, None, :]) & 0xFF).to(torch.uint8)
        if return_state:
            out["ser_rows"] = torch.cat([owner0[None], lv["shifts"], lv["eps"].reshape(-1, nb),
                                         run_rid[None], applied[None]]).to(torch.int32)
            out["ser_q"] = torch.stack([(lv["q"] >> (8 * k)) & 0xFF
                                        for k in range(3)]).to(torch.uint8)
        return out


def fused_merged_pre(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
                     need_q: bool = True, fused_layout: str = "morton", device="cuda"):
    """Stages A-E with run building, on ``device``, in the kernels' layout
    ``fused_layout``. The state's ``n_run_blocks`` (a 0-d tensor) is what
    ``encode_image_merged`` reads on the host to size the coalesce buffer;
    pair with ``fused_merged_finish``."""
    _check_supported(num_levels, "match", fused_layout)
    img = _as_image_tensor(image, resolve_device(device))
    return _fused_pre(img, cfg, seed, num_levels, need_q, coalesce=True,
                      fused_layout=fused_layout)


def fused_merged_finish(state: dict, cfg: EncodeConfig, seed: int, num_levels: int,
                        emit_planes: bool, cap: int, return_state: bool = False,
                        fused_layout: str = "morton"):
    """Stages F-G on a ``fused_merged_pre`` state: the coalesce pass at the
    member capacity ``cap``, then the outputs of
    ``encode_image_merged_fused_device``. ``seed`` and ``fused_layout`` must
    be the pre stage's."""
    if state["layout"] != fused_layout:
        raise ValueError(f"a {state['layout']!r} state, fused_layout={fused_layout!r}")
    return _fused_finish(state, cfg, seed, num_levels, emit_planes, cap,
                         return_state=return_state)


def fused_rd_pre(image, cfg: EncodeConfig, seed: int = 0, rd_lambda: float = 0.01,
                 num_levels: int = 3, need_q: bool = True, header_bits: int | None = None,
                 device="cuda"):
    """RD policy, stages A-E with run building, on ``device``
    (limg_tpu/regions.py:1791); pair with ``fused_rd_finish``."""
    # the JAX package's RD path has one layout, whatever fused_layout says
    _check_supported(num_levels, "rd", "morton")
    img = _as_image_tensor(image, resolve_device(device))
    return _rd_pre(img, cfg, seed, num_levels, need_q, rd_lambda, header_bits, coalesce=True)


def fused_rd_finish(state: dict, cfg: EncodeConfig, seed: int, rd_lambda: float,
                    num_levels: int, emit_planes: bool, cap: int,
                    header_bits: int | None = None, return_state: bool = False):
    """RD policy, stages F-G on a ``fused_rd_pre`` state, with the RD
    acceptance of runs; ``seed``, ``rd_lambda`` and ``header_bits`` must be
    the pre stage's."""
    return _fused_finish(state, cfg, seed, num_levels, emit_planes, cap, "rd", rd_lambda,
                         header_bits, return_state)


def encode_image_merged_fused_device(image, cfg: EncodeConfig, seed: int = 0,
                                     num_levels: int = 3, emit_planes: bool = True,
                                     coalesce: bool = True, return_state: bool = False,
                                     cap_frac: int = 8, fused_layout: str = "morton",
                                     device="cuda"):
    """Fused merged encode, match policy, with every output left on ``device``.

    ``cap_frac`` sets the coalesce buffer's capacity directly: 0 and 1 mean
    full capacity, > 1 nb // cap_frac (at least 4096), < 0 pins
    min(nb, -cap_frac). ``fused_layout`` is "morton" or "natural" (the
    kernels' layout). Returns a dict: ``decoded`` (H, W, 4) uint8,
    ``accum_bits`` (3,), ``bits_histogram`` (3, 9), ``alive_counts``
    (num_levels,), ``mean_bpp`` and ``total_err`` (float64 scalars),
    ``merge_stats`` (one dict of reason counts per level 1..num_levels-1),
    ``n_runs`` and ``coalesce_stats`` (dropped_runs_at_capacity,
    overflow_run_blocks, rejected_runs; {} without coalescing); with
    ``emit_planes`` also ``endpoint_rows`` (6ch, NB), ``block_rows8`` (5, NB)
    uint8 [3 shifts, bpp, owner], ``region_rows`` (NB,) and ``factors_pnb``
    (3, 64, NB) uint8; with ``return_state`` also ``ser_rows`` and ``ser_q``,
    the LTP1 serializer's state.
    """
    _check_supported(num_levels, "match", fused_layout)
    img = _as_image_tensor(image, resolve_device(device))
    state = _fused_pre(img, cfg, seed, num_levels, need_q=emit_planes or return_state,
                       coalesce=coalesce, fused_layout=fused_layout)
    cap = _coalesce_cap(cap_frac, state["grid"].num_blocks) if coalesce else None
    return _fused_finish(state, cfg, seed, num_levels, emit_planes, cap,
                         return_state=return_state)


def encode_image_merged_rd_device(image, cfg: EncodeConfig, seed: int = 0,
                                  rd_lambda: float = 0.01, num_levels: int = 3,
                                  emit_planes: bool = True, coalesce: bool = True,
                                  return_state: bool = False, cap_frac: int = 8,
                                  header_bits: int | None = None, device="cuda"):
    """Fused merged encode, RD policy (limg_tpu/regions.py:1763), with every
    output left on ``device``: the outputs of
    ``encode_image_merged_fused_device``, ``merge_stats`` holding kept /
    rd_cost_saved / cost_reject per level. ``header_bits`` is the region
    header the cut and the run acceptance charge (None: the static
    estimate)."""
    # the JAX package's RD path has one layout
    _check_supported(num_levels, "rd", "morton")
    img = _as_image_tensor(image, resolve_device(device))
    state = _rd_pre(img, cfg, seed, num_levels, emit_planes or return_state, rd_lambda,
                    header_bits, coalesce)
    cap = _coalesce_cap(cap_frac, state["grid"].num_blocks) if coalesce else None
    return _fused_finish(state, cfg, seed, num_levels, emit_planes, cap, "rd", rd_lambda,
                         header_bits, return_state)


# ---------------------------------------------------------------------------
# The dense path (limg_tpu/regions.py:173, :522, :903)
# ---------------------------------------------------------------------------

def coalesce_level_bands(levels, grids, owner0: torch.Tensor, cfg: EncodeConfig, seed: int,
                         merge_policy: str, rd_lambda, cap_frac: int,
                         header_bits: int | None, need_planes: bool):
    """Run coalescing of every dense level on its own grid
    (limg_tpu/regions.py:522, per level): each level's regions that own
    their pixels link into runs (``build_runs``, up to SEG_CAP regions a
    run, on the match kernels; one pass of run building for all levels),
    and each level's runs are refitted and re-encoded by the segment
    kernel at the level's P (``coalesce_segments``, its per-level buffer
    capacity from ``cap_frac``, dither key ``coalesce_key(seed,
    cfg.dither_seed, level)``). ``levels`` are updated in place. Returns per
    level (applied (NB_L,) bool, region id (NB_L,) int32: the run's first
    region where applied, else the region's own index), the total runs and
    the summed coalesce stats."""
    ch = cfg.channels
    grid0 = grids[0]
    with span("limg.dense.runs"):
        owner2 = owner0.reshape(grid0.blocks_y, grid0.blocks_x)
        owned = [(owner2[::1 << lvl, ::1 << lvl] == lvl).reshape(-1)
                 for lvl in range(len(levels))]
        rows = [torch.cat([lv["avg"], lv["eps"].reshape(6 * ch, -1).to(torch.float32)])
                for lv in levels]
        matches = neighbor_pair_matches(rows, grids, ch)
        runs = build_runs_levels([(owned[lvl], grids[lvl], SEG_CAP, matches[lvl])
                                  for lvl in range(len(levels))])
    n_runs, stats, info = 0, {}, []
    for lvl, (lv, (seg_id, run_len)) in enumerate(zip(levels, runs)):
        nb = seg_id.shape[0]
        with span(f"limg.dense.coalesce.L{lvl}"):
            applied, n_l, st = coalesce_segments(
                lv["px"], lv["mask"], seg_id, owned[lvl] & (run_len >= 2), lv, cfg,
                coalesce_key(seed, cfg.dither_seed, lvl), _coalesce_cap(cap_frac, nb),
                need_planes, merge_policy, rd_lambda, header_bits, old_header_included=False)
            rid = torch.where(applied, seg_id, torch.arange(nb, dtype=torch.int32,
                                                            device=seg_id.device))
        info.append((applied, rid))
        n_runs = n_runs + n_l
        stats = {k: stats.get(k, 0) + v for k, v in st.items()}
    return info, n_runs, stats


def encode_image_merged_device(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
                               emit_planes: bool = True, merge_policy: str = "match",
                               rd_lambda: float = 0.01, coalesce: bool = True,
                               return_state: bool = False, rd_header_bits: int | None = None,
                               cap_frac: int = 8, device="cuda"):
    """Dense merged encode (limg_tpu/regions.py:903), any number of levels,
    either policy, with every output left on ``device``.

    Every level is encoded on its own (``encode_levels``); the match policy
    merges by ``merge_levels_alive``, the RD policy by ``rd_merge_keep``
    (charging ``rd_header_bits``, None: the static estimate, per region);
    with ``coalesce`` each level's owned regions coalesce into runs
    (``coalesce_level_bands``, ``cap_frac`` as in
    ``encode_image_merged_fused_device``: 0 and 1 are full capacity). Each
    level-0 block takes its owner level's rows and planes. Returns the
    outputs of ``encode_image_merged_fused_device``: ``alive_counts`` the
    alive (match) or kept (RD) regions per level, ``region_rows`` each
    block's region id (the level's offset plus its region's or run's index
    in the level grid), and with ``return_state`` ``ser_q`` as (64, NB)
    packed int32 crushed factors.
    """
    _check_levels(num_levels, merge_policy)
    img = _as_image_tensor(image, resolve_device(device))
    ch = cfg.channels
    words = _words(img)
    grids, levels = encode_levels(words, cfg, seed, num_levels)
    grid0 = grids[0]
    nb0, dev = grid0.num_blocks, words.device
    with span("limg.dense.merge"):
        if merge_policy == "rd":
            extra = (0.0 if rd_header_bits is None
                     else float(rd_header_bits - static_block_bits(ch)))
            alive, merge_stats = rd_merge_keep(levels, grids, num_levels, rd_lambda, extra)
        else:
            alive, merge_stats = merge_levels_alive(levels, grids, ch)
        owner0 = _owner_level(alive, grids, num_levels)

    arange = [torch.arange(g.num_blocks, dtype=torch.int32, device=dev) for g in grids]
    run_info = [(torch.zeros(g.num_blocks, dtype=torch.bool, device=dev), arange[lvl])
                for lvl, g in enumerate(grids)]
    n_runs, coalesce_stats = torch.zeros((), dtype=torch.int64, device=dev), {}
    if coalesce:
        run_info, n_runs, coalesce_stats = coalesce_level_bands(
            levels, grids, owner0, cfg, seed, merge_policy, rd_lambda, cap_frac,
            rd_header_bits if merge_policy == "rd" else None,
            need_planes=emit_planes or return_state)

    # per level-0 block, its owner level's values: rows repeated over the
    # level-0 blocks of a region, pixel planes cut into 8x8 blocks
    def rows0(v, lvl):
        return v if lvl == 0 else _bcast0(v, grids[lvl], grid0, lvl)

    def plane0(v, lvl):
        return v if lvl == 0 else _q_level_to_block0(v, grids[lvl], grid0, lvl)

    def select(fn, per_level):
        out = fn(per_level[0], 0)
        for lvl in range(1, num_levels):
            out = torch.where(owner0 == lvl, fn(per_level[lvl], lvl), out)
        return out

    with span("limg.dense.totals"):
        owner2 = owner0.reshape(grid0.blocks_y, grid0.blocks_x)
        total_err = torch.zeros((), dtype=torch.float64, device=dev)
        bpp_weighted = torch.zeros((), dtype=torch.float64, device=dev)
        accum_bits = torch.zeros(3, dtype=torch.int64, device=dev)
        bits_histogram = torch.zeros((3, 9), dtype=torch.int64, device=dev)
        for lvl, lv in enumerate(levels):
            # the regions owned at this level (the owner map at their top-left block)
            own = (owner2[::1 << lvl, ::1 << lvl] == lvl).reshape(-1)
            cnt = lv["count"].to(torch.int64) * own
            s_eff = torch.clamp(lv["shifts"], max=8).to(torch.int64)
            total_err = total_err + (lv["dist"].to(torch.float64) * own).sum()
            accum_bits = accum_bits + ((8 - s_eff) * cnt[None]).sum(dim=1)
            one_hot = s_eff[:, None, :] == torch.arange(9, device=dev)[None, :, None]
            bits_histogram = bits_histogram + (one_hot * cnt[None, None, :]).sum(dim=2)
            bpp_weighted = bpp_weighted + (lv["bpp"].to(torch.float64) * cnt).sum()

    with span("limg.dense.decoded"):
        decoded = _decoded_image(select(plane0, [lv["dec"] for lv in levels]), grid0)
    out = dict(
        decoded=decoded,
        accum_bits=accum_bits,
        bits_histogram=bits_histogram,
        alive_counts=torch.stack([a.sum() for a in alive]),
        # a tensor divisor: CUDA divides by a host scalar as a product with
        # its reciprocal, one rounding off the CPU's quotient
        mean_bpp=bpp_weighted / torch.tensor(float(grid0.height * grid0.width),
                                             dtype=torch.float64, device=dev),
        total_err=total_err,
        merge_stats=merge_stats,
        n_runs=n_runs,
        coalesce_stats=coalesce_stats,
    )
    if not (emit_planes or return_state):
        return out
    eps0 = select(rows0, [lv["eps"].reshape(6 * ch, -1) for lv in levels])
    shifts0 = select(rows0, [lv["shifts"] for lv in levels])
    q0 = select(plane0, [lv["q"] for lv in levels])
    if emit_planes:
        s_eff0 = torch.clamp(shifts0, max=8)
        offsets = np.cumsum([0] + [g.num_blocks for g in grids[:-1]]).tolist()
        out["endpoint_rows"] = eps0
        out["block_rows8"] = torch.cat([s_eff0, select(rows0, [lv["bpp"] for lv in levels])[None],
                                        owner0[None]]).to(torch.uint8)
        out["region_rows"] = select(rows0, [rid + off for (_, rid), off in zip(run_info, offsets)])
        q = torch.stack([(q0 >> (8 * k)) & 0xFF for k in range(3)])
        out["factors_pnb"] = ((q << s_eff0[:, None, :]) & 0xFF).to(torch.uint8)
    if return_state:
        # a level-L run's level-0 blocks take the run's first region's
        # top-left level-0 block as their run id
        run_rid = arange[0]
        run_applied = torch.zeros(nb0, dtype=torch.bool, device=dev)
        for lvl, (applied, rid) in enumerate(run_info):
            bx = grids[lvl].blocks_x
            rid0 = ((rid // bx) << lvl) * grid0.blocks_x + ((rid % bx) << lvl)
            take = (owner0 == lvl) & rows0(applied, lvl)
            run_rid = torch.where(take, rows0(rid0, lvl), run_rid)
            run_applied = run_applied | take
        out["ser_rows"] = torch.cat([owner0[None], shifts0, eps0, run_rid[None],
                                     run_applied[None]]).to(torch.int32)
        out["ser_q"] = q0
    return out


def _host_outputs(out: dict, cfg: EncodeConfig, num_levels: int, fetch_planes: bool,
                  fetch_decoded: bool, return_state: bool):
    """``encode_image_merged``'s host outputs from a device entry point's
    ``out``: the totals, and the planes and the state where asked."""
    h, w = out["decoded"].shape[:2]
    n = h * w
    mse = float(out["total_err"]) / n
    np_out = dict(
        decoded=out["decoded"].cpu().numpy() if fetch_decoded else None,
        alive_counts=out["alive_counts"].cpu().numpy(),
        bits_histogram=out["bits_histogram"].cpu().numpy(),
        psnr=10.0 * math.log10(max_possible_error(cfg.channels) / max(mse, 1e-12)),
        mse=mse,
        mean_bpp=float(out["mean_bpp"]),
        avg_block_bits=float(out["accum_bits"].sum()) / n,
        merge_stats=[{k: float(v) for k, v in s.items()} for s in out["merge_stats"]],
        n_runs=int(out["n_runs"]),
        coalesce_stats={k: int(v) for k, v in out["coalesce_stats"].items()},
    )
    if fetch_planes:
        by, bx = -(-h // BLOCK_SIZE), -(-w // BLOCK_SIZE)

        def expand(rows):
            v = np.asarray(rows).reshape(-1, by, bx)
            v = np.repeat(np.repeat(v, BLOCK_SIZE, 1), BLOCK_SIZE, 2)
            return v[:, :h, :w]

        grid = layout.grid_for(h, w)
        rows8 = out["block_rows8"].cpu().numpy()
        np_out.update(
            factors=layout.unblockify(out["factors_pnb"], grid).cpu().numpy(),
            shift=expand(rows8[:3]),
            bpp=expand(rows8[3])[0],
            region_id=expand(out["region_rows"].cpu().numpy())[0],
            owner_px=expand(rows8[4])[0],
            endpoint_rows=out["endpoint_rows"].cpu().numpy(),
        )
    if return_state:
        return np_out, dict(height=h, width=w, num_levels=num_levels, channels=cfg.channels,
                            rows=out["ser_rows"].cpu().numpy(), q=out["ser_q"].cpu().numpy(),
                            n_runs=np_out["n_runs"])
    return np_out


def encode_image_merged(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
                        fetch_planes: bool = True, merge_policy: str = "match",
                        rd_lambda: float = 0.01, coalesce: bool = True,
                        return_state: bool = False, rd_header_bits: int | None = None,
                        fetch_decoded: bool = True, cap_frac: int = 0,
                        fused_layout: str = "morton", fused: bool | None = None,
                        device="cuda"):
    """Host-facing merged encode, with the output dict of
    ``limg_tpu.regions.encode_image_merged``: decoded, alive_counts,
    bits_histogram, psnr, mse, mean_bpp, avg_block_bits, merge_stats,
    n_runs, coalesce_stats, and with ``fetch_planes`` factors, shift, bpp,
    region_id, owner_px and endpoint_rows (NumPy arrays).

    ``merge_policy`` is "match" (the default) or "rd", whose cut and run
    acceptance weigh bits + ``rd_lambda`` * distortion, charging
    ``rd_header_bits`` per region (None: the static estimate).
    ``fused_layout`` ("morton" or "natural") picks the match policy's
    kernels; the RD policy ignores it, as the JAX package does.
    ``fused`` picks the path: None (the default) the fused path at 2-4
    levels, on every device; False, and any ``num_levels`` of 1 or of 5
    or more, the dense path (``encode_image_merged_device``; with
    ``fused=True`` 5 levels or more raise ValueError, as the fused entry
    points do). On the fused path ``cap_frac=0`` (the default) is
    auto run capacity: the pre stage runs, the host reads the run-block
    count (one sync), and the coalesce stage runs once at
    ``auto_run_capacity``, so no run is dropped; the dense path takes it as
    full capacity per level. Another value goes to the device entry point
    as it is. ``return_state=True`` returns
    ``(out, state)``, ``state`` the LTP1 serializer's input
    (``limg_tpu.bitstream.serialize_from_state``): height, width,
    num_levels, channels, rows (6ch + 6, NB) int32, q (3, 64, NB) uint8 on
    the fused path or (64, NB) int32 packed factors on the dense path (NumPy
    arrays) and n_runs.
    """
    with span("limg.encode_image_merged"):
        _check_levels(num_levels, merge_policy)
        rd = merge_policy == "rd"
        if fused is False or num_levels == 1 or (fused is None and num_levels > MAX_LEVELS):
            out = encode_image_merged_device(image, cfg, seed, num_levels, fetch_planes,
                                             merge_policy, rd_lambda, coalesce, return_state,
                                             rd_header_bits, 1 if cap_frac == 0 else cap_frac,
                                             device)
        elif coalesce and cap_frac == 0:
            _check_supported(num_levels, merge_policy, fused_layout)
            need_q = fetch_planes or return_state
            if rd:
                state = fused_rd_pre(image, cfg, seed, rd_lambda, num_levels, need_q=need_q,
                                     header_bits=rd_header_bits, device=device)
            else:
                state = fused_merged_pre(image, cfg, seed, num_levels, need_q=need_q,
                                         fused_layout=fused_layout, device=device)
            with span("limg.run_count_read"):
                cap = auto_run_capacity(int(state["n_run_blocks"]), state["grid"].num_blocks)
            out = _fused_finish(state, cfg, seed, num_levels, fetch_planes, cap, merge_policy,
                                rd_lambda, rd_header_bits, return_state)
        elif rd:
            _check_supported(num_levels, merge_policy, fused_layout)
            out = encode_image_merged_rd_device(image, cfg, seed, rd_lambda, num_levels,
                                                fetch_planes, coalesce, return_state,
                                                cap_frac if cap_frac != 0 else 1, rd_header_bits,
                                                device)
        else:
            out = encode_image_merged_fused_device(image, cfg, seed, num_levels, fetch_planes,
                                                   coalesce, return_state,
                                                   cap_frac if cap_frac != 0 else 1,
                                                   fused_layout, device)
        with span("limg.fetch"):
            return _host_outputs(out, cfg, num_levels, fetch_planes, fetch_decoded, return_state)
