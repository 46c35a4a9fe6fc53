"""Bit-crush: per-block adaptive factor bit depth, batched over all blocks.

The reference's serial shift searches (src/limg_bit_crush.h:332-1051) as a
batched evaluation of candidate shift triples for all blocks at once.
Selection rule: among admissible triples, maximize the total shift, then
minimize the block error; (0,0,0) if none is admissible.

Admissibility per triple (limg_encode_try_bit_crush_block_3d_,
src/limg_bit_crush.h:96-313): simulated integer decode with factors >> s,
per-pixel weighted error <= maxPixelBitCrushError, and
blockError * 0x10 < maxBlockBitCrushError * numPixels.

Search modes (config.crush_mode):

- "guess":      the reference's canned triples with its nested acceptance
                (src/limg_bit_crush.h:332-392);
- "ladder":     27 per-axis sweeps, an additive error model ranks a boxed
                4^3 lattice, exact verification of the top K;
- "exhaustive": all 729 triples exactly.

Regions: ``find_shifts`` takes a reducer (ops/reduce.py). Each candidate's
pixel max and block error are reduced per block, then across the region's
blocks, and admissibility is tested on the region values. Regions of 2048
pixels or more pre-scale the block error (``err_scale_shift``); segments
of the run-coalescing buffer shift each block's error sum right by
SEG_ERR_SHIFT less that pre-scale (``SegmentReducer.seg_err_shift``), and
both compare in float32 (the JAX package's ``find_shifts_segments``,
limg_tpu/ops/segments.py:368).

Everything here is integer arithmetic with int32 wrap-around, except the
reduced-factor floors and the pre-scaled comparison, which compare in
float32. The CUDA kernels (csrc/limg_common.cuh) make the same choices bit
for bit.
"""

from __future__ import annotations

import torch

from ..config import EncodeConfig
from .decode import decode_blocks
from .error import weighted_error
from .fit import Decomposition
from .reduce import BlockReducer

GUESS_TRIPLES = ((4, 5, 6), (5, 8, 8), (4, 6, 8), (2, 4, 5))
_BIG_I32 = 2**31 - 1
_EVAL_CHUNK = 9     # candidates evaluated per batched pass (bounds memory)


def err_scale_shift(pixels: int) -> int:
    """Block-error pre-scale for regions of ``pixels`` pixels (the JAX
    package's ``_err_scale_shift``, limg_tpu/ops/crush.py:44).

    Per-pixel weighted errors reach 780300, so at 2048 pixels or more the
    int32 sum could overflow: errors are shifted right by 4 before the sum
    and the admissibility test compares in float32. The fused kernels pass
    the most pixels a region can hold, 64 * 4^(levels-1): at 4 levels every
    region is pre-scaled, level-0 owners included; at 2 and 3 none is. The
    RD policy's level encodes pass their region's P: only its 64x64 regions
    (P = 4096) are pre-scaled."""
    return 4 if pixels >= 2048 else 0


def _all_triples() -> list[tuple[int, int, int]]:
    return [(a, b, c) for a in range(9) for b in range(9) for c in range(9)]


def _const_cands(triples, n: int, device) -> torch.Tensor:
    """Static triples -> (K, 3, n) int32 candidate shifts."""
    t = torch.tensor(triples, dtype=torch.int32, device=device)
    return t[:, :, None].expand(len(triples), 3, n)


def evaluate_batch(px, mask_i, f8, d: Decomposition, cands, channels: int,
                   err_scale: int = 0):
    """Exact per-block errors of K per-block shift triples.

    px: (ch, P, N) i32; mask_i: (P, N) i32 (0/1); f8: (3, P, N) i32
    uncrushed factors; cands: (K, 3, N) i32. Returns (pix_max, block_err),
    each (K, N) int32; block_err sums ``err >> err_scale``.
    """
    pm_out, be_out = [], []
    for start in range(0, cands.shape[0], _EVAL_CHUNK):
        c = cands[start:start + _EVAL_CHUNK]                  # (k, 3, N)
        q = f8 >> torch.clamp(c, max=8)[..., None, :]         # (k, 3, P, N)
        dec = decode_blocks(q, c, d, channels)                # (k, ch, P, N)
        err = weighted_error(dec.transpose(0, 1), px[:, None]) * mask_i  # (k, P, N)
        pm_out.append(err.amax(dim=1))
        be_out.append((err >> err_scale).sum(dim=1, dtype=torch.int32))
    return torch.cat(pm_out), torch.cat(be_out)


def evaluate_shifts(px, mask_i, f8, d: Decomposition, shifts, channels: int):
    """Errors for per-block shifts (3, N). Returns (pix_max, block_err), the
    block error pre-scaled by ``err_scale_shift(P)`` as the JAX package's
    ``evaluate_shifts`` does (limg_tpu/ops/crush.py:70), its int32 sum
    wrapping as there."""
    pm, be = evaluate_batch(px, mask_i, f8, d, shifts[None], channels,
                            err_scale_shift(px.shape[1]))
    return pm[0], be[0]


def _admissible(pix_max, block_err, count, cfg: EncodeConfig, floors=None,
                err_scale: int = 0):
    """Shift-triple admissibility.

    ``floors``: (pix_floor, blk_floor), the errors at zero shifts, in the
    reduced-factor modes (num_factors < 3): the dropped axes leave an
    irreducible error, so the thresholds bound the increment above it,
    compared in float32. Without floors and pre-scale the test is the
    reference's exact integer one (int32 wrap-around, like the kernel).
    """
    max_pix = cfg.max_pixel_bit_crush_error
    max_blk = cfg.max_block_bit_crush_error
    scale = float(0x10 << err_scale)
    if floors is None:
        if err_scale == 0:
            return (pix_max <= max_pix) & (block_err * 0x10 < max_blk * count)
        lhs = block_err.to(torch.float32) * scale
        return (pix_max <= max_pix) & (lhs < count.to(torch.float32) * float(max_blk))
    pix_floor, blk_floor = floors
    lhs = block_err.to(torch.float32) * scale
    rhs = count.to(torch.float32) * float(max_blk) + blk_floor.to(torch.float32) * scale
    return (pix_max <= max_pix + pix_floor) & (lhs < rhs)


def _select(cands, pm, be, count, cfg, floors, best, ties_to_later: bool,
            err_scale: int = 0):
    """Fold K evaluated candidates into the running best, in order.

    best = (shifts (3, N), total (N,), err (N,)). A candidate replaces the
    best if it is admissible with a larger total, or an equal total and a
    smaller error (or an equal one, with ``ties_to_later``)."""
    best_s, best_tot, best_err = best
    ok = _admissible(pm, be, count[None], cfg,
                     None if floors is None else (floors[0][None], floors[1][None]),
                     err_scale)
    totals = torch.clamp(cands, max=8).sum(dim=1, dtype=torch.int32)           # (K, N)
    for i in range(cands.shape[0]):
        better = be[i] <= best_err if ties_to_later else be[i] < best_err
        take = ok[i] & ((totals[i] > best_tot) | ((totals[i] == best_tot) & better))
        best_s = torch.where(take[None], cands[i], best_s)
        best_tot = torch.where(take, totals[i], best_tot)
        best_err = torch.where(take, be[i], best_err)
    return best_s, best_tot, best_err


def _init_best(n: int, device):
    return (torch.zeros((3, n), dtype=torch.int32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device),
            torch.full((n,), _BIG_I32, dtype=torch.int32, device=device))


def exhaustive_core(eval_batch, count, cfg: EncodeConfig, n: int, floors=None,
                    err_scale: int = 0):
    """All 729 triples in ascending lex order; on equal (total, error) the
    later (lexicographically larger) triple wins."""
    device = count.device
    best = _init_best(n, device)
    triples = _all_triples()
    for start in range(0, len(triples), 81):
        cands = _const_cands(triples[start:start + 81], n, device)
        pm, be = eval_batch(cands)
        best = _select(cands, pm, be, count, cfg, floors, best, ties_to_later=True,
                       err_scale=err_scale)
    return best[0], best[2]


def guess_core(eval_batch, count, cfg: EncodeConfig, n: int, floors=None,
               err_scale: int = 0):
    """The reference's canned-guess acceptance logic, batched.

    if ok(4,5,6): pick (5,8,8) if ok else (4,6,8) if ok else (4,5,6)
    else:         pick (2,4,5) if ok else (0,0,0)
    """
    device = count.device
    cands = _const_cands(GUESS_TRIPLES, n, device)
    pm, be = eval_batch(cands)
    ok = _admissible(pm, be, count[None], cfg,
                     None if floors is None else (floors[0][None], floors[1][None]),
                     err_scale)
    t = cands[:, :, :1]                                       # (4, 3, 1)
    zero = torch.zeros_like(t[0])
    hi = torch.where(ok[1][None], t[1], torch.where(ok[2][None], t[2], t[0]))
    lo = torch.where(ok[3][None], t[3], zero)
    shifts = torch.where(ok[0][None], hi, lo)
    big = torch.full_like(be[0], _BIG_I32)
    err = torch.where(
        ok[0], torch.where(ok[1], be[1], torch.where(ok[2], be[2], be[0])),
        torch.where(ok[3], be[3], big))
    return shifts, err


def _gather9(rows: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """rows (9, N) indexed per block by s (m, N) -> (m, N)."""
    return torch.gather(rows, 0, s.long())


def _lattice(vals) -> torch.Tensor:
    """Three (4, N) per-axis rows -> (64, N) sums, index oa*16 + ob*4 + oc."""
    a, b, c = vals
    n = a.shape[-1]
    return (a[:, None, None] + b[None, :, None] + c[None, None, :]).reshape(64, n)


def ladder_core(eval_batch, count, cfg: EncodeConfig, n: int, floors=None,
                err_scale: int = 0):
    """Additive-model ranking over a boxed lattice + exact top-K verify.

    Stage 1: 27 exact evaluations, each axis alone at shifts 0..8. Stage 2:
    per axis, base_k = the largest shift admissible with the other axes
    unquantized; candidates are the 4^3 box s_k = max(base_k - o_k, 0),
    o_k in {0..3}, ranked by one int32 key (approx-admissible, total shift,
    -approx error). Stage 3: exact verification of the top K, best-ranked
    first; a later candidate wins only with a larger total or a strictly
    smaller error.
    """
    device = count.device
    k = cfg.ladder_k
    sweep = [tuple(s if ax == a else 0 for ax in range(3))
             for a in range(3) for s in range(9)]
    pm27, be27 = eval_batch(_const_cands(sweep, n, device))
    pix_ax = [pm27[9 * a:9 * (a + 1)] for a in range(3)]      # (9, N) each
    blk_ax = [be27[9 * a:9 * (a + 1)] for a in range(3)]
    pix0, err0 = pix_ax[0][0], blk_ax[0][0]
    fl9 = None if floors is None else (floors[0][None], floors[1][None])

    s_iota = torch.arange(9, dtype=torch.int32, device=device)[:, None]
    offs = torch.arange(4, dtype=torch.int32, device=device)[:, None]
    base, s_cand, d_blk_at, d_pix_at = [], [], [], []
    for a in range(3):
        adm = _admissible(pix_ax[a], blk_ax[a], count[None], cfg, fl9, err_scale)
        b = torch.where(adm, s_iota, 0).amax(dim=0)           # (N,)
        s = torch.clamp(b[None] - offs, min=0)                # (4, N)
        base.append(b)
        s_cand.append(s)
        d_blk_at.append(_gather9(blk_ax[a] - blk_ax[a][0][None], s))
        d_pix_at.append(_gather9(pix_ax[a] - pix_ax[a][0][None], s))

    approx_blk = err0[None] + _lattice(d_blk_at)
    approx_pix = pix0[None] + _lattice(d_pix_at)
    totals = _lattice(s_cand)
    adm = _admissible(approx_pix, approx_blk, count[None], cfg, fl9,
                      err_scale).to(torch.int32)
    err_pack = (2**25 - 1) - torch.clamp(approx_blk >> 6, max=2**25 - 1)
    key = (adm << 30) + (totals << 25) + err_pack             # (64, N)

    # peel the K best indices by repeated argmax, min index on ties
    iota64 = torch.arange(64, dtype=torch.int32, device=device)[:, None]
    peeled = []
    for _ in range(k):
        m = key.amax(dim=0)
        idx = torch.where(key == m[None], iota64, 64).amin(dim=0)
        peeled.append(idx)
        key = torch.where(iota64 == idx[None], -(2**31) + 1, key)
    top = torch.stack(peeled)                                 # (K, N) best first
    offs_k = [top // 16, (top // 4) % 4, top % 4]
    cands = torch.stack(
        [torch.clamp(base[a][None] - offs_k[a], min=0) for a in range(3)], dim=1
    ).to(torch.int32)                                         # (K, 3, N)
    pm, be = eval_batch(cands)
    best = _select(cands, pm, be, count, cfg, floors, _init_best(n, device),
                   ties_to_later=False, err_scale=err_scale)
    return best[0], best[2]


def force_dropped_axes(shifts: torch.Tensor, num_factors: int) -> torch.Tensor:
    """Statically dropped axes (k >= num_factors) always store shift 8."""
    if num_factors >= 3:
        return shifts
    forced = torch.tensor([0] * num_factors + [8] * (3 - num_factors),
                          dtype=torch.int32, device=shifts.device)
    return torch.maximum(shifts, forced[:, None])


_CORES = {"exhaustive": exhaustive_core, "guess": guess_core, "ladder": ladder_core}


def _search(core, eval_batch, count, cfg: EncodeConfig, err_scale: int):
    """Run a search core over the regions of ``count``, with the zero-shift
    floors of the reduced-factor modes (num_factors < 3)."""
    n = count.shape[-1]
    floors = None
    if cfg.num_factors < 3:
        pm0, be0 = eval_batch(_const_cands([(0, 0, 0)], n, count.device))
        floors = (pm0[0], be0[0])
    return core(eval_batch, count, cfg, n, floors, err_scale)


def _block_search(core, px, mask_i, f8, d: Decomposition, count, cfg: EncodeConfig):
    es = err_scale_shift(px.shape[1])
    return _search(core, lambda c: evaluate_batch(px, mask_i, f8, d, c, px.shape[0], es),
                   count, cfg, es)


def find_shifts_exhaustive(px, mask_i, f8, d: Decomposition, count, cfg: EncodeConfig):
    """The exhaustive search of each block alone, on int32 inputs: px (ch, P,
    N), mask_i (P, N), f8 (3, P, N), count (N,) (the JAX package's
    ``find_shifts_exhaustive``, limg_tpu/ops/crush.py:345). Returns (shifts
    (3, N), block_err (N,))."""
    return _block_search(exhaustive_core, px, mask_i, f8, d, count, cfg)


def find_shifts_guess(px, mask_i, f8, d: Decomposition, count, cfg: EncodeConfig):
    """The guess search of each block alone; see ``find_shifts_exhaustive``."""
    return _block_search(guess_core, px, mask_i, f8, d, count, cfg)


def find_shifts_ladder(px, mask_i, f8, d: Decomposition, count, cfg: EncodeConfig):
    """The ladder search of each block alone; see ``find_shifts_exhaustive``."""
    return _block_search(ladder_core, px, mask_i, f8, d, count, cfg)


def find_shifts(px_u8, mask, f8_u8, d: Decomposition, cfg: EncodeConfig, red=None,
                use_kernel: bool = False):
    """Dispatch by cfg.crush_mode. Returns (shifts (3, R) i32, block_err (R,)),
    R the regions of ``red``'s values: the blocks, or a ``ScatterReducer``'s
    segments.

    ``f8_u8``: the three (P, NB) uint8 factor planes (or a (3, P, NB)
    tensor); ``d``: the decomposition the search decodes with (already
    axis-dropped when cfg.num_factors < 3), region values broadcast to
    member blocks; ``red``: the region reducer (default: each block alone).
    ``use_kernel`` sends every batch of candidate evaluations through
    kernels/crush_eval.py ``crush_eval_rows_kernel`` (the counterpart of
    limg_tpu/ops/segments.py:402-455), which takes blocks of at most 256
    pixels without an error pre-scale; the plain versions keep the default.
    """
    red = BlockReducer() if red is None else red
    channels = cfg.channels
    px = px_u8[:channels].to(torch.int32)
    mask_i = mask.to(torch.int32)
    count = red.sum(mask_i)
    f8 = torch.stack([p.to(torch.int32) for p in f8_u8])
    n = count.shape[-1]
    if not cfg.crush_bits:
        return (torch.zeros((3, n), dtype=torch.int32, device=px.device),
                torch.zeros((n,), dtype=torch.int32, device=px.device))
    es = err_scale_shift(px.shape[1] * red.chunks)
    # a segment's block errors, pre-scaled by es, shift right by the rest
    # of its seg_err_shift before the cross-block sum, so admissibility
    # scales by seg_err_shift whatever P (limg_tpu/ops/segments.py:397, :416)
    ss = red.seg_err_shift - es if red.seg_err_shift else 0

    if use_kernel:
        from ..kernels.crush_eval import MAX_PIXELS, crush_eval_rows_kernel, pack_words

        if px.shape[1] > MAX_PIXELS or es:
            raise ValueError(f"crush_eval_rows_kernel takes blocks of at most {MAX_PIXELS} "
                             f"pixels and no error pre-scale, got P = {px.shape[1]}, "
                             f"pre-scale {es}")
        packed, f8_packed = pack_words(px), pack_words(f8)
        eps = torch.stack(list(d[1:]))

        def evaluate(cands):
            return crush_eval_rows_kernel(packed, mask_i, f8_packed, eps, cands, channels)
    else:
        def evaluate(cands):
            return evaluate_batch(px, mask_i, f8, d, cands, channels, es)

    def eval_batch(cands):
        pm, be = evaluate(red.to_blocks(cands))
        return red.combine_max(pm), red.combine_sum(be >> ss)

    return _search(_CORES.get(cfg.crush_mode, ladder_core), eval_batch, count, cfg, es + ss)
