"""Quadtree-merged encoder, fused path, match policy, with run coalescing.

The counterpart of the JAX package's fused merged encode
(limg_tpu/regions.py: ``_fused_pre_body`` :1182, ``_fused_finish_body``
:1393, ``encode_image_merged_fused_device`` :1544, ``fused_merged_pre`` /
``fused_merged_finish`` :1589-1616, ``encode_image_merged`` :1828). Every
quadtree level is fitted, each parent merges when all four children are
alive and match its first child, every block is crushed once at its owner
level (two kernels, kernels/encode_merged.py). Then run coalescing, the
JAX default: matching neighbour regions of each level link into horizontal
runs, vertical runs and rectangles (``build_runs``, on the match kernels),
the run blocks are compacted into a buffer sorted by segment, each segment
is refitted and re-encoded as one region (the segment kernel), and a run
is kept when it does not cost more bits than its blocks did
(``coalesce_segments``, kernels/coalesce.py). On a CUDA device these are
hand-written kernels; on the CPU their plain versions.

The port keeps every per-block plane in row-major block order, so the JAX
package's Morton lane relayouts (``mpos``, ``embed_rows``) and
``_stride_take`` have no counterpart here.

Not ported here, and raising NotImplementedError: the RD policy, the LTP1
serializer state, the dense path (``num_levels`` outside 2-4) and
``fused_layout="natural"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import BLOCK_SIZE, EncodeConfig, static_block_bits
from .encoder import _as_image_tensor, resolve_device
from .kernels.coalesce import (match_neighbors_kernel, match_pairs_kernel,
                               seg_min_all, seg_mixed_all_kernel, seg_sum_all,
                               segment_encode_kernel)
from .kernels.encode_merged import MAX_LEVELS, MIN_LEVELS, fit_levels_kernel, owner_crush_kernel
from .ops import layout
from .ops.dither import coalesce_key
from .ops.error import max_possible_error
from .ops.match import MATCH_REASON_BITS
from .ops.segments import SEG_CAP

# argument -> the ROADMAP.md item that ports it
_NOT_PORTED = {
    "merge_policy": "Queue 1 item 12",
    "return_state": "Queue 1 item 10",
    "num_levels": "Queue 1 item 13",
    "fused_layout": "Queue 2 row 9",
}

# level grids of this many blocks or more take the neighbour-match kernel;
# smaller ones are paired into one match_pairs launch (limg_tpu/regions.py:298)
NEIGHBOR_KERNEL_MIN_BLOCKS = 16384


def _check_supported(num_levels: int, merge_policy: str, return_state: bool,
                     fused_layout: str) -> None:
    def refuse(arg, what):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md {_NOT_PORTED[arg]})")

    if merge_policy != "match":
        refuse("merge_policy", f"merge_policy={merge_policy!r}")
    if return_state:
        refuse("return_state", "return_state=True (LTP1 serializer state)")
    if not MIN_LEVELS <= num_levels <= MAX_LEVELS:
        refuse("num_levels", f"num_levels={num_levels} (the dense merged path)")
    if fused_layout == "natural":
        refuse("fused_layout", "fused_layout='natural'")
    if fused_layout != "morton":
        raise ValueError(f"fused_layout must be 'morton' or 'natural', got {fused_layout!r}")


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


def _axis_run_len(seg2: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-cell length of runs contiguous along ``axis`` of a 2-D segment
    map, by the segment scan (row boundaries always break segments, so the
    flattened scan is safe)."""
    s = seg2 if axis == 1 else seg2.t()
    ln = seg_sum_all(torch.ones(s.numel(), dtype=torch.int32, device=s.device),
                     s.reshape(-1)).reshape(s.shape)
    return ln if axis == 1 else ln.t()


def build_runs(owned: torch.Tensor, grid: layout.BlockGrid, max_members: int, matches):
    """Link owned cells of one level into runs of matching neighbours.

    Horizontal runs link left, horizontal singletons link up into vertical
    runs, and equal-span horizontal runs stack into rectangles when every
    vertical pair matches (limg_tpu/regions.py:376 ``build_runs``).
    ``owned``: (NB,) bool; ``matches``: this level's (m_left, m_up) from
    ``neighbor_pair_matches``. Returns (seg_id (NB,) int32, the run's first
    cell's flat index; run_len (NB,) int32 per cell).
    """
    max_members = max(2, max_members)
    rw_cap = min(16, max(2, int(max_members ** 0.5)))
    rh_cap = max(1, max_members // rw_cap)
    gy, gx = grid.blocks_y, grid.blocks_x
    nb, dev = gy * gx, owned.device
    own2 = owned.reshape(gy, gx)
    idx2 = torch.arange(nb, dtype=torch.int32, device=dev).reshape(gy, gx)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)

    # horizontal runs
    if gx > 1:
        link_left = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
        link_left[:, 1:] = matches[0] & own2[:, 1:] & own2[:, :-1]
        link_left &= (torch.arange(gx, device=dev) % max_members != 0)[None, :]
        seg_h2 = torch.cummax(torch.where(link_left, neg, idx2), dim=1).values
        len_h = _axis_run_len(seg_h2, 1).reshape(-1)
        seg_h = seg_h2.reshape(-1)
    else:
        seg_h2 = idx2
        seg_h = idx2.reshape(-1)
        len_h = torch.ones(nb, dtype=torch.int32, device=dev)

    # vertical runs of horizontal singletons
    if gy > 1:
        m_up = matches[1]
        elig2 = (owned & (len_h == 1)).reshape(gy, gx)
        link_up = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
        link_up[1:] = m_up & elig2[1:] & elig2[:-1]
        link_up &= (torch.arange(gy, device=dev) % max_members != 0)[:, None]
        seg_v2 = torch.cummax(torch.where(link_up, neg, idx2), dim=0).values
        # the length scan runs along columns: ids as first positions in
        # the transposed flat order
        ids_t = (seg_v2 % gx) * gy + seg_v2 // gx
        len_v = _axis_run_len(ids_t.t(), 1).t().reshape(-1)
        elig = elig2.reshape(-1)
        seg_id = torch.where(elig, seg_v2.reshape(-1), seg_h)
        run_len = torch.where(elig, len_v, len_h)
    else:
        seg_id, run_len = seg_h, len_h

    # rectangles: vertically aligned equal-span horizontal runs whose
    # vertical block pairs all match (the AND is a segment min)
    if gy > 1 and gx > 1:
        len_h2 = len_h.reshape(gy, gx)
        is_hrun = own2 & (len_h2 >= 2) & (len_h2 <= rw_cap)
        vmatch = torch.zeros((gy, gx), dtype=torch.int32, device=dev)
        vmatch[1:] = m_up.to(torch.int32)
        vand = seg_min_all(vmatch.reshape(-1), seg_h, 1).reshape(gy, gx)
        same_span = torch.zeros((gy, gx), dtype=torch.bool, device=dev)
        same_span[1:] = (seg_h2[1:] - gx == seg_h2[:-1]) & (len_h2[1:] == len_h2[:-1])
        hrun_above = torch.zeros_like(is_hrun)
        hrun_above[1:] = is_hrun[:-1]
        link_rect = (same_span & (vand > 0) & is_hrun & hrun_above
                     & (torch.arange(gy, device=dev) % rh_cap != 0)[:, None])
        yy = torch.arange(gy, dtype=torch.int32, device=dev)[:, None].expand(gy, gx)
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
    seg0 = lead0
    is_run0 = torch.zeros(nb, dtype=torch.bool, device=owner0.device)
    for lvl in range(num_levels):
        seg_l, len_l = build_runs(owned[lvl], grids[lvl], SEG_CAP >> (2 * lvl), matches[lvl])
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
                      key: int, cap: int, need_planes: bool):
    """Re-encode the run blocks grouped by ``seg_id`` and write back the
    runs that do not cost more bits (match policy).

    ``px_plane`` / ``mask_plane``: (64, NB) int32 words / bool of every
    block; ``lv``: the per-block rows of the owner-level encode (``shifts``
    (3, NB), ``bits`` with the region header on leaders, ``bpp``, ``dist``,
    ``eps`` (6, ch, NB), ``avg`` (ch, NB), ``dec`` and ``q`` (64, NB) planes),
    updated in place. The run blocks are sorted by (is_run, seg_id), so each
    segment is contiguous, and the first ``cap`` go into the buffer; the one
    segment the capacity cut splits is reverted and counted. Returns
    (applied (NB,) bool, n_runs, coalesce_stats).
    """
    ch = cfg.channels
    nb, dev = seg_id.shape[0], seg_id.device
    cap = min(nb, cap)
    order, seg_c = compact_runs(seg_id, is_run, cap)
    sel = order[:cap]
    seg_orig, sel_is_run = seg_id[sel], is_run[sel]
    old_bits_sel = lv["bits"][sel]
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
    n_overflow = is_run.sum() - sel_is_run.sum()

    enc = segment_encode_kernel(packed_c, mask_c, seg_c, sel.to(torch.int32), cfg, key,
                                emit_q=need_planes)
    s_eff = torch.clamp(enc.shifts, max=8)
    fac_bits_blk = ((8 - s_eff) * enc.count_blk[None]).sum(dim=0, dtype=torch.int32)
    header = static_block_bits(ch)
    bits_blk = fac_bits_blk + header * is_start.to(torch.int32)
    old_bits_masked = torch.where(sel_is_run, old_bits_sel, 0)
    sums = seg_mixed_all_kernel(torch.stack([fac_bits_blk, old_bits_masked]), seg_c, 2)
    bits_mem = sums[0] + header
    bpp_mem = torch.clamp((bits_mem + enc.count_mem // 2) // torch.clamp(enc.count_mem, min=1),
                          max=0xFF)
    accept = ok_c & (bits_mem <= sums[1])

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

def _fused_pre(img: torch.Tensor, cfg: EncodeConfig, seed: int, num_levels: int,
               need_q: bool, coalesce: bool):
    """Stages A-E: fit every level, merge test and owner select (one kernel),
    crush at the owner level (one kernel), leaders and bits, and with
    ``coalesce`` run building."""
    ch = cfg.channels
    words = _words(img)
    grid = layout.grid_for(*words.shape)
    fit = fit_levels_kernel(words, cfg, num_levels)
    crush = owner_crush_kernel(words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, num_levels,
                               seed, emit_q=need_q)
    merge_stats = [{name: (r & bit).ne(0).sum() for name, bit in MATCH_REASON_BITS}
                   for r in fit.reasons]
    lead0 = _leaders(fit.owner, grid, num_levels)
    s_eff0 = torch.clamp(crush.shifts, max=8)
    fac_bits0 = ((8 - s_eff0) * fit.cnt0[None]).sum(dim=0, dtype=torch.int32)
    is_leader0 = lead0 == torch.arange(grid.num_blocks, device=lead0.device)
    state = dict(
        grid=grid, fit=fit, crush=crush, merge_stats=merge_stats, lead0=lead0,
        # per-block bits with the region header on its leader: what run
        # coalescing weighs a refit against
        bits0=fac_bits0 + static_block_bits(ch) * is_leader0.to(torch.int32),
        seg0=None, is_run0=None,
        n_run_blocks=torch.zeros((), dtype=torch.int64, device=lead0.device),
    )
    if coalesce:
        seg0, is_run0 = build_runs_multilevel(fit.owner, fit.avg_sel, fit.eps_sel, lead0,
                                              grid, num_levels, ch)
        px_plane, mask_plane, _ = layout.blockify_words(words)
        state.update(seg0=seg0, is_run0=is_run0, n_run_blocks=is_run0.sum(),
                     px=px_plane, mask=mask_plane)
    return state


def _decoded_image(dec_packed: torch.Tensor, grid: layout.BlockGrid) -> torch.Tensor:
    """(64, NB) packed decoded words -> (H, W, 4) uint8."""
    words = layout.unblockify(dec_packed[None], grid, BLOCK_SIZE)[..., 0]
    return words.contiguous().view(torch.uint8).reshape(grid.height, grid.width, 4)


def _fused_finish(state: dict, cfg: EncodeConfig, seed: int, num_levels: int,
                  emit_planes: bool, cap: int | None):
    """Stages F-G: with a run capacity ``cap`` (None: no coalescing) the
    coalesce pass, then the stats as flat level-0 sums, the decoded image,
    and with ``emit_planes`` the per-block planes."""
    grid, fit, crush = state["grid"], state["fit"], state["crush"]
    nb, dev = grid.num_blocks, fit.cnt0.device
    lv = dict(shifts=crush.shifts, bits=state["bits0"], bpp=crush.bpp, dist=crush.dist_blk,
              eps=fit.eps_sel, avg=fit.avg_sel, dec=crush.dec, q=crush.q)
    n_runs = torch.zeros((), dtype=torch.int64, device=dev)
    coalesce_stats, rid_blk = {}, state["lead0"]
    if cap is not None:
        # the coalesce pass updates the rows in place: work on copies
        lv = {k: None if v is None else v.clone() for k, v in lv.items()}
        applied, n_runs, coalesce_stats = coalesce_segments(
            state["px"], state["mask"], state["seg0"], state["is_run0"], lv, cfg,
            coalesce_key(seed, cfg.dither_seed), cap, need_planes=emit_planes)
        rid_blk = torch.where(applied, state["seg0"], rid_blk)
    cnt0 = fit.cnt0.to(torch.int64)
    s_eff0 = torch.clamp(lv["shifts"], max=8).to(torch.int64)
    one_hot = s_eff0[:, None, :] == torch.arange(9, device=dev)[None, :, None]
    out = dict(
        decoded=_decoded_image(lv["dec"], grid),
        accum_bits=((8 - s_eff0) * cnt0[None]).sum(dim=1),
        bits_histogram=(one_hot * cnt0[None, None, :]).sum(dim=2),
        alive_counts=torch.stack([((fit.stats_bits >> lvl) & 1).sum()
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
             fit.owner[None].to(torch.int64)]).to(torch.uint8)               # (5, NB)
        out["region_rows"] = fit.owner * nb + rid_blk
        q = torch.stack([(lv["q"] >> (8 * k)) & 0xFF for k in range(3)])
        out["factors_pnb"] = ((q << s_eff0[:, None, :]) & 0xFF).to(torch.uint8)
    return out


def fused_merged_pre(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
                     need_q: bool = True, device="cuda"):
    """Stages A-E with run building, on ``device``. The state's
    ``n_run_blocks`` (a 0-d tensor) is what ``encode_image_merged`` reads
    on the host to size the coalesce buffer; pair with
    ``fused_merged_finish``."""
    _check_supported(num_levels, "match", False, "morton")
    img = _as_image_tensor(image, resolve_device(device))
    return _fused_pre(img, cfg, seed, num_levels, need_q, coalesce=True)


def fused_merged_finish(state: dict, cfg: EncodeConfig, seed: int, num_levels: int,
                        emit_planes: bool, cap: int):
    """Stages F-G on a ``fused_merged_pre`` state: the coalesce pass at the
    member capacity ``cap``, then the outputs of
    ``encode_image_merged_fused_device``. ``seed`` must be the pre
    stage's."""
    if emit_planes and state["crush"].q is None:
        raise ValueError("emit_planes needs a state made with need_q=True")
    return _fused_finish(state, cfg, seed, num_levels, emit_planes, cap)


def encode_image_merged_fused_device(image, cfg: EncodeConfig, seed: int = 0,
                                     num_levels: int = 3, emit_planes: bool = True,
                                     coalesce: bool = True, return_state: bool = False,
                                     merge_policy: str = "match", cap_frac: int = 8,
                                     fused_layout: str = "morton", device="cuda"):
    """Fused merged encode with every output left on ``device``.

    ``cap_frac`` sets the coalesce buffer's capacity directly: 0 and 1 mean
    full capacity, > 1 nb // cap_frac (at least 4096), < 0 pins
    min(nb, -cap_frac). Returns a dict: ``decoded`` (H, W, 4) uint8,
    ``accum_bits`` (3,), ``bits_histogram`` (3, 9), ``alive_counts``
    (num_levels,), ``mean_bpp`` and ``total_err`` (float64 scalars),
    ``merge_stats`` (one dict of reason counts per level 1..num_levels-1),
    ``n_runs`` and ``coalesce_stats`` (dropped_runs_at_capacity,
    overflow_run_blocks, rejected_runs; {} without coalescing); with
    ``emit_planes`` also ``endpoint_rows`` (6ch, NB), ``block_rows8`` (5, NB)
    uint8 [3 shifts, bpp, owner], ``region_rows`` (NB,) and ``factors_pnb``
    (3, 64, NB) uint8.
    """
    _check_supported(num_levels, merge_policy, return_state, fused_layout)
    img = _as_image_tensor(image, resolve_device(device))
    state = _fused_pre(img, cfg, seed, num_levels, need_q=emit_planes, coalesce=coalesce)
    cap = _coalesce_cap(cap_frac, state["grid"].num_blocks) if coalesce else None
    return _fused_finish(state, cfg, seed, num_levels, emit_planes, cap)


def encode_image_merged(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
                        fetch_planes: bool = True, merge_policy: str = "match",
                        coalesce: bool = True, return_state: bool = False,
                        fetch_decoded: bool = True, cap_frac: int = 0,
                        fused_layout: str = "morton", device="cuda"):
    """Host-facing merged encode, with the output dict of
    ``limg_tpu.regions.encode_image_merged``: decoded, alive_counts,
    bits_histogram, psnr, mse, mean_bpp, avg_block_bits, merge_stats,
    n_runs, coalesce_stats, and with ``fetch_planes`` factors, shift, bpp,
    region_id, owner_px and endpoint_rows (NumPy arrays).

    ``cap_frac=0`` (the default) is auto run capacity: the pre stage runs,
    the host reads the run-block count (one sync), and the coalesce stage
    runs once at ``auto_run_capacity``, so no run is dropped. Another value
    goes to ``encode_image_merged_fused_device`` as it is.
    """
    _check_supported(num_levels, merge_policy, return_state, fused_layout)
    if coalesce and cap_frac == 0:
        state = fused_merged_pre(image, cfg, seed, num_levels, need_q=fetch_planes,
                                 device=device)
        cap = auto_run_capacity(int(state["n_run_blocks"]), state["grid"].num_blocks)
        out = _fused_finish(state, cfg, seed, num_levels, fetch_planes, cap)
    else:
        out = encode_image_merged_fused_device(image, cfg, seed, num_levels, fetch_planes,
                                               coalesce, return_state, merge_policy,
                                               cap_frac if cap_frac != 0 else 1,
                                               fused_layout, device)
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
    return np_out
