"""The reduction orders of the quadtree kernels (csrc/encode_merged.cuh:
the fit and the owner crush), the region encode (csrc/region_encode.cuh:
the fixed grid and the RD levels) and the run-coalescing kernels
(csrc/coalesce.cu: the segment encode, the one-thread neighbour match),
emulated lane by lane in torch and held bit-equal to the plain versions'
orders and results (ops/reduce.py, ops/segments.py, ops/crush.py,
ops/match.py), on the CPU; and the segment kernel's short path for
segments with no member pixel, held to the plain version's outputs.

The kernels run only on the card; what these tests pin is that each
layout of work over lanes adds floats in the order the plain versions
(and through them the JAX package) use:

- the fit lays a block over 8 lanes, lane l holding pixels l + 8 k
  (column l, rows k = 0..7): the natural layout's sum is a left fold over
  k in the lane, then xor butterflies 1, 2, 4; the halving tree would be
  in-lane adds k + 4, k + 2, k + 1, then butterflies 4, 2, 1;
- a warp holds 4 blocks in Morton order: level-1 sums are butterflies 8, 16;
  a square's warps exchange one value per lane and combine 4^(l-1) of them
  by butterflies 1, 2, 4, 8: the pairwise-adjacent tree;
- the segment kernel scans a segment of up to 32 members within one warp,
  shuffles up and down by 1, 2, 4, 8, 16 that skip partners outside the
  segment: the doubling scan's fwd + bwd - x;
- the owner crush lays a block over 8 lanes as the fit does: a candidate's
  pixel max and error sum per lane, then per block, warp and region (any
  order: integers); the 25 distinct sweeps in one batch, the ladder's 64
  keys 8 a lane, peeled by an arg-max over the packed (key, 63 - index),
  the K candidates in batches of 8; a region's dist by xor 8, 16 and the
  warps' pairwise tree;
- match_neighbors gives each thread one block, and match_pairs one pair:
  its 27 probes fold left in the thread, and are skipped where the bit
  does not depend on them;
- seg_scan gives a CTA one row over a 1,536-lane tile of one problem in a
  2,048-lane window, warp w holding 32-lane chunks framed by one chunk on
  each side: steps d < 32 rotate a chunk by one shuffle and take a partner
  across its edge from the neighbouring chunk, d >= 32 go through shared
  memory: the doubling scan's order, fwd + bwd - x;
- the region encode gives each of a region's T = P / 8 threads the pixels
  t + T j: its sums are the halving tree's in-thread levels, one exchange
  across the region's warps (P = 1024, 4096), then butterflies (8 lanes a
  block at P = 64, a warp from 256 on); its crush search is the owner
  crush's (csrc/crush_search.cuh), every lane of a region at level
  log4(P / 64); above P = 4096 a cluster of cs CTAs takes a region, CTA i
  the pixels p = i mod cs, walked as chunks of 4096 folded as a binary
  counter, then the P = 4096 region's tree, then the CTAs' sums by the
  halving tree over the ranks.
"""

import functools

import numpy as np
import pytest
import torch

from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import coalesce as kc
from limg_tpu_torch.kernels import encode_merged as km
from limg_tpu_torch.kernels import quadtree
from limg_tpu_torch.ops import crush
from limg_tpu_torch.ops.decode import decode_blocks
from limg_tpu_torch.ops.error import weighted_error
from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
from limg_tpu_torch.ops.fit import (Decomposition, drop_decomposition_axes, fit_regions,
                                   inv_or_zero, tree_sum)
from limg_tpu_torch.ops.layout import unpack_plane
from limg_tpu_torch.ops.match import _COLOR_DIFF_FACTORS, _normals, match_decomps
from limg_tpu_torch.ops.reduce import OwnerReducer, SegmentReducer, nat_block_sum, pairwise_tree
from limg_tpu_torch.ops.segments import scan_steps, seg_mixed_all

torch.set_num_threads(1)


def _butterfly(v: torch.Tensor, offsets, op) -> torch.Tensor:
    """xor-shuffle butterflies over the last axis (the lanes): each lane
    combines its value with lane ^ off's, its own first."""
    lanes = torch.arange(v.shape[-1])
    for off in offsets:
        v = op(v, v[..., lanes ^ off])
    return v


def _lanes8(x: torch.Tensor) -> torch.Tensor:
    """(..., 64, N) pixels -> (..., N, 8 rows k, 8 lanes l): lane l holds
    pixels l + 8 k."""
    return x.reshape(*x.shape[:-2], 8, 8, x.shape[-1]).movedim(-1, -3)


def _random_blocks(seed: int, n: int = 96) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 64, n)) * rng.uniform(1e-3, 1e3, (3, 64, n))
    x[:, :, ::7] = 0.0                          # masked pixels and empty blocks
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_split_natural_fold_is_nat_block_sum(seed):
    x = _random_blocks(seed)
    cols = _lanes8(x)                           # (3, N, k, l)
    s = cols[..., 0, :]
    for k in range(1, 8):                       # in-lane left fold over the rows
        s = s + cols[..., k, :]
    s = _butterfly(s, (1, 2, 4), torch.add)     # then across the 8 columns
    want = nat_block_sum(x)
    for lane in range(8):                       # every lane holds the block's sum
        assert torch.equal(s[..., lane], want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_split_halving_tree_is_tree_sum(seed):
    x = _random_blocks(seed)
    cols = _lanes8(x)
    s = cols[..., :4, :] + cols[..., 4:, :]     # in-lane steps 32, 16, 8 of the tree
    s = s[..., :2, :] + s[..., 2:, :]
    s = s[..., 0, :] + s[..., 1, :]
    s = _butterfly(s, (4, 2, 1), torch.add)     # then steps 4, 2, 1 across lanes
    want = tree_sum(x, -2)
    for lane in range(8):
        assert torch.equal(s[..., lane], want)


@pytest.mark.parametrize("op", [torch.add, torch.minimum, torch.maximum])
def test_warp_level1_butterflies_are_the_morton_pairwise_tree(op):
    """A warp's 4 blocks (lanes 8 b + l) combine by butterflies 8, 16."""
    rng = np.random.default_rng(5)
    rows = torch.from_numpy((rng.standard_normal((2, 64)) * 1e3).astype(np.float32))
    lanes = rows.reshape(2, 16, 4)[..., None].expand(2, 16, 4, 8).reshape(2, 16, 32)
    got = _butterfly(lanes, (8, 16), op).reshape(2, 16, 4, 8)
    want = pairwise_tree(rows, 4, op).reshape(2, 16, 4)
    for lane in range(8):
        assert torch.equal(got[..., lane], want)


@pytest.mark.parametrize("group", [4, 16])
@pytest.mark.parametrize("op", [torch.add, torch.minimum, torch.maximum])
def test_square_exchange_tree_is_the_morton_pairwise_tree(group, op):
    """The exchange puts one value per warp; lanes q G .. q G + G - 1 take
    value q of the G warps of a group and combine them by butterflies 1,
    2, ..., G / 2, then every lane takes value q from lane q G."""
    rng = np.random.default_rng(group)
    n_vals, n_groups = 6, 5
    warps = torch.from_numpy((rng.standard_normal((n_vals, n_groups * group)) * 1e3)
                             .astype(np.float32))
    per = 32 // group
    got = torch.empty_like(warps)
    for g in range(n_groups):
        slots = warps[:, g * group:(g + 1) * group]
        for r in range(-(-n_vals // per)):
            lane_vals = torch.zeros(32)
            for lane in range(32):
                i = r * per + lane // group
                if i < n_vals:
                    lane_vals[lane] = slots[i, lane % group]
            lane_vals = _butterfly(lane_vals, [1 << b for b in range(group.bit_length() - 1)], op)
            for q in range(per):
                if r * per + q < n_vals:
                    got[r * per + q, g * group:(g + 1) * group] = lane_vals[q * group]
    assert torch.equal(got, pairwise_tree(warps, group, op))


def _segments(rng, n: int, spans) -> torch.Tensor:
    """Segment ids (first member's position) of consecutive spans."""
    seg, i = [], 0
    for span in spans:
        span = min(span, n - i)
        seg += [i] * span
        i += span
        if i >= n:
            break
    seg += list(range(i, n))
    return torch.tensor(seg, dtype=torch.int32)


@pytest.mark.parametrize("spans", [(1, 31, 32, 5, 17, 2), (32, 32, 32), (7,) * 12, (1,) * 40,
                                   (29, 3, 30, 2, 31, 1)])
@pytest.mark.parametrize("n_sum", [0, 3])
def test_in_warp_segment_scan_is_the_doubling_scan(spans, n_sum):
    """A warp scans a segment of n <= 32 members: lane j holds member j,
    fwd takes lane j - d's value for j >= d, bwd lane j + d's for j + d <
    n, d = 1, 2, 4, 8, 16; sums finish as fwd + bwd - x, maxima as
    max(fwd, bwd)."""
    rng = np.random.default_rng(len(spans) + n_sum)
    n = 300
    seg = _segments(rng, n, spans)
    x = torch.from_numpy((rng.standard_normal((3, n)) * rng.uniform(1e-2, 1e4, (3, n)))
                         .astype(np.float32))
    want = seg_mixed_all(x, seg, n_sum)
    got = torch.empty_like(x)
    lanes = torch.arange(32)
    starts = [i for i in range(n) if seg[i] == i]
    for s in starts:
        m = int((seg == s).sum())
        assert m <= 32
        for r in range(3):
            v = torch.zeros(32)
            v[:m] = x[r, s:s + m]
            op = torch.add if r < n_sum else torch.maximum
            f, b = v.clone(), v.clone()
            for d in (1, 2, 4, 8, 16):
                up = f[(lanes - d).clamp(min=0)]
                down = b[(lanes + d).clamp(max=31)]
                f = torch.where(lanes >= d, op(f, up), f)
                b = torch.where(lanes + d < m, op(b, down), b)
            out = (f + b) - v if r < n_sum else torch.maximum(f, b)
            got[r, s:s + m] = out[:m]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# seg_scan: one row over a 1,536-lane tile of one problem a CTA (csrc/coalesce.cu)
# ---------------------------------------------------------------------------

SCAN_WARPS, SCAN_CHUNKS, SEG_CAP = 16, 4, 256
SCAN_WINDOW = SCAN_WARPS * SCAN_CHUNKS * 32
SCAN_TILE = SCAN_WINDOW - 2 * SEG_CAP


def _tile_scan(x: torch.Tensor, seg: torch.Tensor, op: str, fill: float) -> torch.Tensor:
    """seg_scan_kernel's lanes for one row, every tile at once: warp w holds
    window lanes 128 w + 32 (r - 1) + l in register chunk r = 0..5 (chunks
    0 and 5 frame the warp's four), lanes outside the problem carry ids -1
    (left) and -2 (right) and ``fill``. Each step's guard compares the ids
    (from shared memory), and a partner outside the registers (d < 32) or
    the window (d >= 32) counts as another segment. Steps d < 32 rotate each
    chunk by d lanes (one shuffle) and take a lane l < d's partner from the
    rotated chunk r - 1; d >= 32 read the window's lane j - d in shared
    memory. Sums finish as fwd + bwd - x, maxima as max(fwd, bwd), a min as
    -max(-x)."""
    n = x.shape[0]
    steps = scan_steps(n)
    tiles = -(-n // SCAN_TILE)
    w = torch.arange(SCAN_WARPS)[:, None, None]
    r = torch.arange(SCAN_CHUNKS + 2)[None, :, None]
    lane = torch.arange(32)[None, None, :]
    j = w * SCAN_CHUNKS * 32 + 32 * (r - 1) + lane                  # (16, 6, 32) window lanes
    g = torch.arange(tiles)[:, None, None, None] * SCAN_TILE - SEG_CAP + j   # (T, 16, 6, 32)
    inside = (g >= 0) & (g < n)
    gi = g.clamp(0, max(n - 1, 0))
    ids = torch.where(inside, seg[gi], torch.where(g < 0, -1, -2))
    neg = op == "n"
    xv = torch.where(inside, -x[gi] if neg else x[gi], torch.tensor(fill, dtype=x.dtype))
    comb = torch.add if op == "s" else torch.maximum

    def rotate(v, d, up):
        return v[..., (lane[0, 0] - d) % 32] if up else v[..., (lane[0, 0] + d) % 32]

    f, b = xv.clone(), xv.clone()
    for d in [dd for dd in steps if dd < 32]:
        uf, ub = rotate(f, d, True), rotate(b, d, False)
        uid, dnid = rotate(ids, d, True), rotate(ids, d, False)
        pf = torch.where(lane >= d, uf, torch.roll(uf, 1, dims=2))       # chunk r - 1
        pfid = torch.where(lane >= d, uid, torch.roll(uid, 1, dims=2))
        pb = torch.where(lane + d < 32, ub, torch.roll(ub, -1, dims=2))  # chunk r + 1
        pbid = torch.where(lane + d < 32, dnid, torch.roll(dnid, -1, dims=2))
        okf = (pfid == ids) & ((lane >= d) | (r > 0))
        okb = (pbid == ids) & ((lane + d < 32) | (r < SCAN_CHUNKS + 1))
        f, b = torch.where(okf, comb(f, pf), f), torch.where(okb, comb(b, pb), b)
    # the shared-memory steps over the window (chunks 1..4 of every warp)
    centre = slice(1, SCAN_CHUNKS + 1)
    win = lambda v: v[:, :, centre].reshape(tiles, SCAN_WINDOW)           # noqa: E731
    f, b, sid, x0, gw = win(f), win(b), win(ids), win(xv), win(g)
    jj = torch.arange(SCAN_WINDOW)
    for d in [dd for dd in steps if dd >= 32]:
        back = (jj - d).clamp(min=0)
        fwd_ok = (jj >= d) & (sid[:, back] == sid)
        ahead = (jj + d).clamp(max=SCAN_WINDOW - 1)
        bwd_ok = (jj + d < SCAN_WINDOW) & (sid[:, ahead] == sid)
        f, b = (torch.where(fwd_ok, comb(f, f[:, back]), f),
                torch.where(bwd_ok, comb(b, b[:, ahead]), b))
    y = (f + b) - x0 if op == "s" else torch.maximum(f, b)
    if neg:
        y = -y
    out = torch.empty_like(x)
    keep = (jj >= SEG_CAP) & (jj < SEG_CAP + SCAN_TILE) & (gw >= 0) & (gw < n)
    out[gw[keep]] = y[keep]
    return out


@pytest.mark.parametrize("n", [1, 7, 31, 255, 256, 257, 1535, 1536, 1537, 3073, 6000])
@pytest.mark.parametrize("op", ["s", "x", "n"])
def test_tiled_scan_lanes_are_the_doubling_scan(n, op):
    """The batched scan's lanes on float rows, bit-equal to the plain
    chain: problems that end inside a tile, segments over SEG_CAP (a lane
    sees only part), other labels of the runs, repeated and negative ids."""
    from chip_smoke import run_labels

    rng = np.random.default_rng(n * 3 + len(op))
    seg = _segments(rng, n, rng.integers(1, 400, n))
    if n % 2:
        seg = torch.from_numpy(run_labels(rng, seg.numpy()))
    seg[torch.from_numpy(rng.random(n) < 0.05)] = -1         # ids the fills also carry
    x = torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
                         .astype(np.float32))
    fill = -3.4e38 if op == "x" else (2.5 if op == "n" else 0.0)
    if op == "n":
        want = -seg_mixed_all(-x[None], seg, 0, -fill)[0]
    else:
        want = seg_mixed_all(x[None], seg, int(op == "s"), fill)[0]
    got = _tile_scan(x, seg, op, -fill if op == "n" else fill)
    assert torch.equal(got, want)
    assert torch.equal(kc.seg_scan([kc.ScanProblem(seg, (x,), op, fill)])[0][0], want)


# ---------------------------------------------------------------------------
# The segment kernel's short path: segments with no member pixel
# ---------------------------------------------------------------------------

def _short_path(n: int, ch: int, num_factors: int, emit_q: bool) -> kc.SegmentEncode:
    """What csrc/coalesce.cu write_empty writes for the lanes of a
    segment with no member pixel, without the fit and search: zero
    endpoints, avg, counts and distortion; shifts 0, or 8 on statically
    dropped axes; zero crushed factors; the zero decode (alpha 255 for
    RGB)."""
    shifts = torch.tensor([0 if k < num_factors else 8 for k in range(3)],
                          dtype=torch.int32)[:, None].expand(3, n)
    dec0 = 0 if ch == 4 else np.int32(-16777216)            # 0xFF000000
    return kc.SegmentEncode(
        shifts=shifts, q=torch.zeros((64, n), dtype=torch.int32) if emit_q else None,
        dec=torch.full((64, n), int(dec0), dtype=torch.int32),
        dist_blk=torch.zeros(n), count_blk=torch.zeros(n, dtype=torch.int32),
        count_mem=torch.zeros(n, dtype=torch.int32), eps=torch.zeros((6, ch, n), dtype=torch.int32),
        avg=torch.zeros((ch, n)))


CRUSH_CASES = [(mode, nf, dith) for mode in ("ladder", "exhaustive", "guess", "none")
               for nf in (1, 2, 3) for dith in (False, True)]


@pytest.mark.parametrize("mode,nf,dith", CRUSH_CASES)
@pytest.mark.parametrize("ch", [3, 4])
def test_segment_short_path_equals_the_plain_version(mode, nf, dith, ch):
    """A buffer whose tail holds segments with no member pixel (singletons
    and longer ones, after run members): the plain version gives those
    lanes exactly the short path's outputs, bit for bit (-0.0 included)."""
    rng = np.random.default_rng(ch * 100 + nf)
    n, members = 48, 20
    px = rng.integers(0, 256, (4, 64, n), np.int64)
    words = px[0] | (px[1] << 8) | (px[2] << 16) | (px[3] << 24)
    words = torch.from_numpy(np.where(words >= 2**31, words - 2**32, words).astype(np.int32))
    mask = torch.zeros((64, n), dtype=torch.bool)
    mask[:, :members] = torch.from_numpy(rng.random((64, members)) < 0.9)
    seg = _segments(rng, n, (3, 9, 1, 7, 5, 4, 1, 6, 12))
    blocks = torch.from_numpy(rng.permutation(4 * n)[:n].astype(np.int32))
    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode, dithering=dith,
                       num_factors=nf)
    out = kc.segment_encode_reference(words, mask, seg, blocks, cfg, 0x5EED)
    empty = torch.tensor([not bool(mask[:, seg == seg[i]].any()) for i in range(n)])
    assert empty.sum() >= n - members - 3 and not empty[:members - 6].any()
    want = _short_path(int(empty.sum()), ch, nf, True)
    for name, got_f, want_f in zip(kc.SegmentEncode._fields, out, want):
        got_f = got_f[..., empty]
        assert got_f.dtype == want_f.dtype, name
        if got_f.dtype.is_floating_point:
            assert torch.equal(got_f.view(torch.int32), want_f.view(torch.int32)), name
        else:
            assert torch.equal(got_f, want_f), name


# ---------------------------------------------------------------------------
# The owner crush: 8 lanes a block, 4 blocks a warp (csrc/encode_merged.cuh
# CrushLane)
# ---------------------------------------------------------------------------

SENTINEL = -(2**31) + 1


def _peel_lanes(key: torch.Tensor, k: int) -> list:
    """The kernel's peel: lane l holds keys l + 8 j; each lane's best packed
    (key, 63 - index), then a max by xor 1, 2, 4; the winner is set to the
    sentinel. key (64, N) -> k (N,) indices."""
    key = key.clone().to(torch.int64)
    idx = torch.arange(64)[:, None]
    out = []
    for _ in range(k):
        packed = (key * 64 + (63 - idx)).reshape(8, 8, -1)        # (j, lane, N)
        lane_best = packed.amax(dim=0)                           # (lane, N)
        best = _butterfly(lane_best.t(), (1, 2, 4), torch.maximum)[:, 0]
        win = 63 - (best & 63)
        out.append(win)
        key = torch.where(idx == win[None], SENTINEL, key)
    return out


def _peel_argmax(key: torch.Tensor, k: int) -> list:
    """ops/crush.py ladder_core's peel: argmax, lowest index on ties."""
    iota = torch.arange(64, dtype=torch.int32)[:, None]
    out = []
    for _ in range(k):
        m = key.amax(dim=0)
        win = torch.where(key == m[None], iota, 64).amin(dim=0)
        out.append(win.to(torch.int64))
        key = torch.where(iota == win[None], SENTINEL, key)
    return out


@pytest.mark.parametrize("span", [2, 5, 2**31 - 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_eight_keys_a_lane_peel_is_argmax_lowest_index(seed, span):
    """Ties between keys (a span of 2 or 5 values: most keys tie), peeled
    past all 64 (then every key is the sentinel and index 0 wins)."""
    rng = np.random.default_rng(seed)
    key = torch.from_numpy(rng.integers(0, span, (64, 40)).astype(np.int32))
    key[:, :5] = SENTINEL                        # blocks with nothing left to peel
    for got, want in zip(_peel_lanes(key, 70), _peel_argmax(key, 70)):
        assert torch.equal(got, want)


def _morton_inputs(h, w, ch, levels, nf):
    """A small image's Morton-ordered blocks, the fit's owner and factors,
    as owner_crush_body prepares them."""
    from chip_smoke import flat_corner, small_image, with_alpha
    from limg_tpu_torch.regions import _words

    rgb = small_image(h, w)
    img = flat_corner(rgb if ch == 3 else with_alpha(rgb))
    words = _words(torch.from_numpy(np.ascontiguousarray(img)))
    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, num_factors=nf)
    fit = km.fit_levels_reference(words, cfg, levels)
    blocks = km.MortonBlocks(words, levels)
    px = quadtree._unpack(blocks.packed, ch)
    eps = blocks.embed(fit.eps_sel)
    d = Decomposition(torch.zeros(eps.shape[1:], dtype=torch.float32), *eps.unbind(0))
    f8 = quadtree._unpack(blocks.embed_pixels(fit.f8_sel), 3)
    return blocks, px, f8, d, blocks.embed(fit.owner)


def _lane_region(err, owner, levels, es):
    """(K, 64, N) pixel errors -> region (pixel max, error sum) (K, N): per
    lane over its 8 pixels l + 8 k, per block by xor 1, 2, 4, per warp (4
    blocks) and per square's warps for owners 1-3. Integer sums wrap."""
    k, _, n = err.shape
    lanes = err.reshape(k, 8, 8, n)                               # (K, row, lane, N)
    pm = lanes.amax(dim=1).movedim(1, -1)                          # (K, N, lane)
    be = (lanes >> es).sum(dim=1, dtype=torch.int32).movedim(1, -1)
    pm = _butterfly(pm, (1, 2, 4), torch.maximum)[..., 0]
    be = _butterfly(be, (1, 2, 4), torch.add)[..., 0]
    out_pm, out_be = pm.clone(), be.clone()
    for lvl in range(1, levels):
        g = 4 ** lvl
        gm = pm.reshape(k, n // g, g).amax(dim=-1, keepdim=True).expand(k, n // g, g)
        gs = be.reshape(k, n // g, g).sum(dim=-1, dtype=torch.int32, keepdim=True)
        gs = gs.expand(k, n // g, g)
        out_pm = torch.where(owner == lvl, gm.reshape(k, n), out_pm)
        out_be = torch.where(owner == lvl, gs.reshape(k, n), out_be)
    return out_pm, out_be


def _kernel_search(px, mask, f8, d, owner, cfg, levels):
    """The owner crush's search: CrushLane::search on its regions' values.
    Returns the shifts (3, N) and the region counts (N,)."""
    return _search_batches(px, mask, f8, d, cfg,
                           lambda err, es: _lane_region(err, owner, levels, es),
                           crush.err_scale_shift(64 * 4 ** (levels - 1)))


def _search_batches(px, mask, f8, d, cfg, lanes, es):
    """CrushLane::search (csrc/crush_search.cuh) on region values per block:
    its batches and its peel; ``lanes(err, es)`` reduces (K, P, N) pixel
    errors to the (pixel max, error sum) (K, N) of each block's region, as
    the lanes of the kernel do. Returns the shifts (3, N) and the counts."""
    ch, n = cfg.channels, px.shape[-1]
    mask_i = mask.to(torch.int32)

    def region(triples):
        c = (torch.tensor(triples, dtype=torch.int32)[:, :, None].expand(-1, 3, n)
             if isinstance(triples, list) else triples)
        q = f8 >> torch.clamp(c, max=8)[..., None, :]
        err = weighted_error(decode_blocks(q, c, d, ch).transpose(0, 1), px[:, None]) * mask_i
        return (c, *lanes(err, es))

    count = lanes(mask_i[None], 0)[1][0]
    best = crush._init_best(n, px.device)
    if not cfg.crush_bits:
        shifts = best[0]
    elif cfg.crush_mode == "ladder":
        sweep = [(0, 0, 0)] + [tuple(s if ax == a else 0 for ax in range(3))
                               for a in range(3) for s in range(1, 9)]
        _, pm, be = region(sweep)                                 # 25 distinct sweeps
        floors = (pm[0], be[0]) if cfg.num_factors < 3 else None
        fl = None if floors is None else (floors[0][None], floors[1][None])
        base, d_blk, d_pix, s_cand = [], [], [], []
        for a in range(3):
            pm_ax = torch.cat([pm[:1], pm[1 + 8 * a:9 + 8 * a]])
            be_ax = torch.cat([be[:1], be[1 + 8 * a:9 + 8 * a]])
            adm = crush._admissible(pm_ax, be_ax, count[None], cfg, fl, es)
            b = torch.where(adm, torch.arange(9)[:, None], 0).amax(dim=0)
            s = torch.clamp(b[None] - torch.arange(4)[:, None], min=0)
            base.append(b)
            s_cand.append(s)
            d_blk.append(torch.gather(be_ax - be_ax[:1], 0, s.long()))
            d_pix.append(torch.gather(pm_ax - pm_ax[:1], 0, s.long()))
        ablk, apix = be[0][None] + crush._lattice(d_blk), pm[0][None] + crush._lattice(d_pix)
        ok = crush._admissible(apix, ablk, count[None], cfg, fl, es).to(torch.int32)
        key = ((ok << 30) + (crush._lattice(s_cand) << 25)
               + ((2**25 - 1) - torch.clamp(ablk >> 6, max=2**25 - 1)))
        peeled = _peel_lanes(key, cfg.ladder_k)
        for r0 in range(0, cfg.ladder_k, 8):                      # batches of 8
            top = torch.stack(peeled[r0:r0 + 8])
            cands = torch.stack([torch.clamp(base[0][None] - top // 16, min=0),
                                 torch.clamp(base[1][None] - (top // 4) % 4, min=0),
                                 torch.clamp(base[2][None] - top % 4, min=0)], dim=1)
            c, pm_k, be_k = region(cands.to(torch.int32))
            best = crush._select(c, pm_k, be_k, count, cfg, floors, best, False, es)
        shifts = best[0]
    elif cfg.crush_mode == "exhaustive":
        floors = None
        triples = [(a, b, c) for a in range(9) for b in range(9) for c in range(9)]
        for i0 in range(0, 729, 9):                               # batches of 9
            c, pm, be = region(triples[i0:i0 + 9])
            if i0 == 0 and cfg.num_factors < 3:
                floors = (pm[0], be[0])
            best = crush._select(c, pm, be, count, cfg, floors, best, True, es)
        shifts = best[0]
    else:                                                         # guess: (0, 0, 0), then 4
        _, pm, be = region([(0, 0, 0)] + list(crush.GUESS_TRIPLES))
        floors = (pm[0], be[0]) if cfg.num_factors < 3 else None
        fl = None if floors is None else (floors[0][None], floors[1][None])
        ok = crush._admissible(pm[1:], be[1:], count[None], cfg, fl, es)
        t = torch.tensor(crush.GUESS_TRIPLES, dtype=torch.int32)[:, :, None]
        hi = torch.where(ok[1][None], t[1], torch.where(ok[2][None], t[2], t[0]))
        lo = torch.where(ok[3][None], t[3], torch.zeros_like(t[0]))
        shifts = torch.where(ok[0][None], hi, lo)
    return crush.force_dropped_axes(shifts, cfg.num_factors), count


@pytest.mark.parametrize("mode,k", [("ladder", 8), ("ladder", 5), ("ladder", 11),
                                    ("exhaustive", 8), ("guess", 8), ("none", 8)])
@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("levels", [2, 3, 4])
def test_eight_lane_crush_search_is_find_shifts(levels, nf, mode, k):
    """The owner crush's search in the kernel's batches and peel equals
    ops/crush.py find_shifts with the owner reducer (the plain version's
    selection) on a small image cut by both edges, with a flat corner owned
    at the top level."""
    blocks, px, f8, d, owner = _morton_inputs(130, 70, 3, levels, nf)
    cfg = EncodeConfig(error_factor=100, num_factors=nf, crush_mode=mode, ladder_k=k)
    got, count = _kernel_search(px, blocks.mask, f8, d, owner, cfg, levels)
    red = OwnerReducer(owner, levels)
    want = crush.force_dropped_axes(crush.find_shifts(px, blocks.mask, f8, d, cfg, red)[0], nf)
    real = blocks.mask.any(dim=0)
    assert torch.equal(got[:, real], want[:, real])
    assert torch.equal(count[real], red.sum(blocks.mask.to(torch.int32))[real])
    assert (owner[real] == levels - 1).any()       # the top level holds cut squares


# ---------------------------------------------------------------------------
# The one-warp segment encode's crush search (csrc/segment_encode.cuh, P = 64
# and 256): a warp takes a block, each lane its 2^(LOGC+1) pixels; a
# candidate's block values are the warp's pixel max and wrapping sum of
# err >> es (es = block_err_scale, 0 here), its segment's the max and the
# wrapping sum of each block's sum >> (kSegErrShift - es). The ladder's 25
# distinct sweeps go in one pass, each on its axis's base (the other two
# axes' decode at shift 0, made once); the K peeled candidates that are
# sweeps take their values from that pass, the others are evaluated; the
# exhaustive search's rows (s0, s1 fixed) are sweeps of axis 2 on their
# base, two rows a pass
# ---------------------------------------------------------------------------

SEG_ERR_SHIFT = 8                       # csrc/segment_encode.cuh kSegErrShift
_MULT = torch.tensor([1, 2, 4, 8, 17, 36, 85, 255, 0], dtype=torch.int32)   # mult_for


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with wrap-around."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _axis_term(f8, eps, k: int, s) -> torch.Tensor:
    """Axis k's term of the kernel's decode at shift s (an int or (N,)),
    SegLane::axis / add_axis: (ch, P, N)."""
    n_lanes = f8.shape[-1]
    s = torch.as_tensor(s, dtype=torch.int32).expand(n_lanes)
    se = torch.clamp(s, max=8)
    fdec = (f8[k] >> se[None]) * _MULT[se.long()][None]             # (P, N)
    live = s <= 7
    nn = torch.where(live[None], eps[2 * k + 1] - eps[2 * k], 0)     # (ch, N)
    mm = torch.where(live[None] | (k == 0), eps[2 * k], 0)
    return mm[:, None, :] + ((fdec[None] * nn[:, None, :] + 128) >> 8)


def _segment_totals(err: torch.Tensor, seg: torch.Tensor, es: int):
    """(K, P, N) member pixel errors -> each lane's segment's (pixel max,
    error sum) (K, N), as the warp's reductions and the segment's atomics
    give them."""
    pm_blk = err.amax(dim=1)
    be_blk = _wrap32((err >> es).to(torch.int64).sum(dim=1)) >> (SEG_ERR_SHIFT - es)
    ids = seg.long()[None].expand_as(pm_blk)
    pm = torch.full_like(pm_blk, -2**31).scatter_reduce(1, ids, pm_blk, "amax")
    be = _wrap32(torch.zeros(pm_blk.shape, dtype=torch.int64).scatter_add(
        1, ids, be_blk.to(torch.int64)))
    return pm[:, seg.long()], be[:, seg.long()]


def _sweep_index(c: torch.Tensor) -> torch.Tensor:
    """(3, N) triples -> each one's index among the 25 sweeps, or -1
    (segment_encode.cuh sweep_index)."""
    nz = (c > 0).sum(dim=0)
    idx = torch.where(c[0] > 0, c[0], torch.where(c[1] > 0, 8 + c[1],
                                                  torch.where(c[2] > 0, 16 + c[2], 0)))
    return torch.where(nz > 1, -1, idx)


def _segment_kernel_search(px, mask, f8, d, seg, cfg, p):
    """The segment template's search (segment_encode_kernel's crush) on one
    run buffer: (3, N) shifts, statically dropped axes forced to 8."""
    n, nf = px.shape[-1], cfg.num_factors
    es = crush.err_scale_shift(p)
    eps = torch.stack(list(d[1:]))                                   # (6, ch, N)
    mask_i = mask.to(torch.int32)
    ids = seg.long()
    count = torch.zeros(n, dtype=torch.int64).index_add(0, ids, mask_i.sum(0).long())
    count = count[ids].to(torch.int32)

    def err_of(est):
        return weighted_error(torch.clamp(est, 0, 255), px) * mask_i

    def totals(errs):
        return _segment_totals(torch.stack(errs), seg, es)

    def full(c):
        return err_of(sum(_axis_term(f8, eps, k, c[k]) for k in range(3)))

    floors = None
    best = crush._init_best(n, px.device)
    if not cfg.crush_bits or cfg.crush_mode == "none":
        shifts = best[0]
    elif cfg.crush_mode == "ladder":
        errs = []
        for ax in range(3):                                          # one pass
            o = [k for k in range(3) if k != ax]
            base = _axis_term(f8, eps, o[0], 0) + _axis_term(f8, eps, o[1], 0)
            errs += [err_of(base + _axis_term(f8, eps, ax, s)) for s in range(ax > 0, 9)]
        pm, be = totals(errs)                                        # (25, N)
        if nf < 3:
            floors = (pm[0], be[0])
        fl = None if floors is None else (floors[0][None], floors[1][None])
        base, d_blk, d_pix, s_cand = [], [], [], []
        for a in range(3):                                           # ladder_box
            pm_ax = torch.cat([pm[:1], pm[1 + 8 * a:9 + 8 * a]])
            be_ax = torch.cat([be[:1], be[1 + 8 * a:9 + 8 * a]])
            adm = crush._admissible(pm_ax, be_ax, count[None], cfg, fl, SEG_ERR_SHIFT)
            b = torch.where(adm, torch.arange(9)[:, None], 0).amax(dim=0)
            s = torch.clamp(b[None] - torch.arange(4)[:, None], min=0)
            base.append(b)
            s_cand.append(s)
            d_blk.append(torch.gather(be_ax - be_ax[:1], 0, s.long()))
            d_pix.append(torch.gather(pm_ax - pm_ax[:1], 0, s.long()))
        ablk, apix = be[0][None] + crush._lattice(d_blk), pm[0][None] + crush._lattice(d_pix)
        ok = crush._admissible(apix, ablk, count[None], cfg, fl, SEG_ERR_SHIFT).to(torch.int32)
        key = ((ok << 30) + (crush._lattice(s_cand) << 25)
               + ((2**25 - 1) - torch.clamp(ablk >> 6, max=2**25 - 1)))
        for top in _peel_argmax(key, cfg.ladder_k):                  # best-ranked first
            c = torch.stack([torch.clamp(base[0] - top // 16, min=0),
                             torch.clamp(base[1] - (top // 4) % 4, min=0),
                             torch.clamp(base[2] - top % 4, min=0)]).to(torch.int32)
            x = _sweep_index(c)
            pm_r, be_r = totals([full(c)])
            sweep = x >= 0
            pm_c = torch.where(sweep, pm.gather(0, x.clamp(min=0).long()[None])[0], pm_r[0])
            be_c = torch.where(sweep, be.gather(0, x.clamp(min=0).long()[None])[0], be_r[0])
            best = crush._select(c[None], pm_c[None], be_c[None], count, cfg, floors, best,
                                 False, SEG_ERR_SHIFT)
        shifts = best[0]
    elif cfg.crush_mode == "exhaustive":
        for r0 in range(0, 81, 2):                                   # two rows a pass
            errs, trips = [], []
            for row in range(r0, min(r0 + 2, 81)):
                base = _axis_term(f8, eps, 0, row // 9) + _axis_term(f8, eps, 1, row % 9)
                errs += [err_of(base + _axis_term(f8, eps, 2, s2)) for s2 in range(9)]
                trips += [(row // 9, row % 9, s2) for s2 in range(9)]
            pm, be = totals(errs)
            if r0 == 0 and nf < 3:
                floors = (pm[0], be[0])
            c = torch.tensor(trips, dtype=torch.int32)[:, :, None].expand(-1, 3, n)
            best = crush._select(c, pm, be, count, cfg, floors, best, True, SEG_ERR_SHIFT)
        shifts = best[0]
    else:                                                            # guess: (0, 0, 0), then 4
        trips = [(0, 0, 0)] + list(crush.GUESS_TRIPLES)
        pm, be = totals([full(torch.tensor(t, dtype=torch.int32)[:, None].expand(3, n))
                         for t in trips])
        fl = (pm[:1], be[:1]) if nf < 3 else None
        ok = crush._admissible(pm[1:], be[1:], count[None], cfg, fl, SEG_ERR_SHIFT)
        t = torch.tensor(crush.GUESS_TRIPLES, dtype=torch.int32)[:, :, None]
        hi = torch.where(ok[1][None], t[1], torch.where(ok[2][None], t[2], t[0]))
        lo = torch.where(ok[3][None], t[3], torch.zeros_like(t[0]))
        shifts = torch.where(ok[0][None], hi, lo)
    return crush.force_dropped_axes(shifts, nf)


# spans of the run buffers: segments of 1, 31, 32, 33 and 256 members, then
# a tail of segments with no member pixel; the exhaustive search's shorter
SEGMENT_SEARCH_SPANS = {64: (1, 31, 32, 33, 256), 256: (1, 31, 32, 33),
                        "exhaustive": (1, 2, 3, 1, 5, 1, 9)}
SEGMENT_SEARCH_TAIL = (3, 1, 2)


@functools.lru_cache(maxsize=None)
def _segment_search_inputs(p: int, ch: int, nf: int, spans: tuple):
    """A seeded run buffer of regions of p pixels, each segment a colour
    with a gradient and noise of its own amplitude (so that the shifts
    found range from 0 to 8), 10% of its pixels not members; and the plain
    version's fit of it (kernels/coalesce.py _segment_encode's steps)."""
    rng = np.random.default_rng(p + 10 * ch + nf)
    seg = _segments(rng, sum(spans) + sum(SEGMENT_SEARCH_TAIL), spans + SEGMENT_SEARCH_TAIL)
    n = seg.numel()
    first = seg.numpy()
    colour = rng.integers(0, 256, (4, n))[:, first]
    amp = rng.choice([0.5, 2.0, 6.0, 20.0, 60.0], n)[first]
    ramp = np.linspace(-1.0, 1.0, p)[None, :, None] * rng.uniform(-8, 8, (4, 1, n))[:, :, first]
    px = colour[:, None, :] + ramp + rng.standard_normal((4, p, n)) * amp
    px = np.clip(np.rint(px), 0, 255).astype(np.int64)
    if ch == 3:
        px[3] = 0
    mask = rng.random((p, n)) < 0.9
    mask[:, n - sum(SEGMENT_SEARCH_TAIL):] = False
    words = px[0] | (px[1] << 8) | (px[2] << 16) | (px[3] << 24)
    words = torch.from_numpy(np.where(words >= 2**31, words - 2**32, words).astype(np.int32))
    mask = torch.from_numpy(mask)
    blocks = torch.from_numpy(rng.permutation(4 * n)[:n].astype(np.int32))
    planes = torch.stack([unpack_plane(words, c) for c in range(ch)])
    red = SegmentReducer(seg)
    d, _ = fit_regions(planes, mask, ch, red)
    f8 = torch.stack([q.to(torch.int32) for q in quantize_factors(*extract_factors(planes, d, ch))])
    return (words, mask, seg, blocks), planes.to(torch.int32), f8, drop_decomposition_axes(d, nf)


@pytest.mark.parametrize("mode,k,ef", [("ladder", 1, 100), ("ladder", 5, 100), ("ladder", 8, 100),
                                       ("ladder", 11, 100), ("ladder", 8, 10),
                                       ("exhaustive", 8, 100), ("guess", 8, 100),
                                       ("none", 8, 100)])
@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("p", [64, 256])
def test_segment_template_search_is_find_shifts(p, nf, mode, k, ef):
    """The one-warp segment encode's search in its passes (the sweeps on
    per-axis bases, verified sweeps' values reused, exhaustive rows as
    axis-2 sweeps) equals the plain version's shifts
    (kernels/coalesce.py segment_encode_reference) and ops/crush.py
    find_shifts with the segment reducer, on a seeded run buffer of
    segments of 1-256 members and a tail with no member (RGB at P = 64,
    RGBA at 256; error factor 10 gives small shifts, where verified ladder
    candidates are often sweeps)."""
    ch = 3 if p == 64 else 4
    spans = SEGMENT_SEARCH_SPANS["exhaustive" if mode == "exhaustive" else p]
    buf, px, f8, d = _segment_search_inputs(p, ch, nf, spans)
    cfg = EncodeConfig(error_factor=ef, has_alpha=ch == 4, num_factors=nf, crush_mode=mode,
                       ladder_k=k)
    got = _segment_kernel_search(px, buf[1], f8, d, buf[2], cfg, p)
    want = crush.force_dropped_axes(
        crush.find_shifts(px, buf[1], f8, d, cfg, SegmentReducer(buf[2]))[0], nf)
    assert torch.equal(got, want)
    assert torch.equal(got, kc.segment_encode_reference(*buf, cfg, 0x5EED).shifts)
    if mode != "none" and ef == 100:                    # not all shifts alike
        assert (got[:nf] == 0).any() and (got[:nf] > 1).any()
    assert not got[:nf, -sum(SEGMENT_SEARCH_TAIL):].any()      # no member: (0, 0, 0)


# ---------------------------------------------------------------------------
# The region encode: regions of P = 64, 256, 1024 or 4096 pixels on the owner
# crush's lanes (csrc/region_encode.cuh), thread t of the T = P / 8 threads
# of a region holding pixels t + T j
# ---------------------------------------------------------------------------

def _region_threads(x: torch.Tensor) -> torch.Tensor:
    """(..., P, N) -> (..., N, T, 8): thread t holds pixels t + T j."""
    p, n = x.shape[-2:]
    return x.reshape(*x.shape[:-2], 8, p // 8, n).movedim(-1, -3).transpose(-1, -2)


def _region_lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The region encode's float sum of (P, N) pixel values: per thread the
    halving tree's in-thread levels (j + 4, j + 2, j + 1); threads of one
    warp by butterflies T/2 ... 1 (16 ... 1 at T >= 32); at T > 32 first the
    exchange, whose every warp folds the region's W warps lane by lane in
    the tree's order (w + W/2, ..., w + 1). Returns each thread's result
    (N, T)."""
    v = _region_threads(x)                                 # (N, T, 8)
    v = v[..., :4] + v[..., 4:]
    v = v[..., :2] + v[..., 2:]
    v = v[..., 0] + v[..., 1]                              # (N, T)
    t = v.shape[-1]
    if t > 32:
        w = t // 32
        xw = v.reshape(-1, w, 32)                          # lane l of warp i: thread 32 i + l
        while xw.shape[1] > 1:
            half = xw.shape[1] // 2
            xw = xw[:, :half] + xw[:, half:]
        v = xw[:, 0][:, None, :].expand(-1, w, 32).reshape(-1, t)
    width = min(t, 32)
    lanes = v.reshape(v.shape[0], -1, width)
    lanes = _butterfly(lanes, [width >> b for b in range(1, width.bit_length())], torch.add)
    return lanes.reshape(v.shape)


@pytest.mark.parametrize("p", [64, 256, 1024, 4096])
@pytest.mark.parametrize("seed", [0, 1])
def test_region_lane_halving_tree_is_tree_sum(p, seed):
    """P = 64: 8 lanes a block (in-lane k + 4, + 2, + 1, then xor 4, 2, 1);
    256: a warp; 1024: 4 warps and one exchange; 4096: 16 warps and one
    exchange. Every thread of a region holds ops/fit.py tree_sum, bit for
    bit, on random floats with masked (zero) pixels."""
    rng = np.random.default_rng(seed * 7 + p)
    n = 24
    x = rng.standard_normal((p, n)) * rng.uniform(1e-3, 1e3, (p, n))
    x[rng.random((p, n)) < 0.2] = 0.0
    x = torch.from_numpy(x.astype(np.float32))
    got = _region_lane_sum(x)                              # (N, T)
    want = tree_sum(x, 0)
    for t in range(p // 8):
        assert torch.equal(got[:, t].view(torch.int32), want.view(torch.int32))


def _counter_fold(chunks: torch.Tensor) -> torch.Tensor:
    """(C, ...) chunk values -> their sum as the kernel's chunk_fold takes
    it: chunk bit_rev(t) at step t, folded as a binary counter (the partial
    of level l first)."""
    c = chunks.shape[0]
    logc = c.bit_length() - 1
    part = [None] * (logc + 1)
    for t in range(c):
        out = chunks[int(format(t, f"0{logc}b")[::-1], 2) if logc else 0]
        lvl = 0
        while (t >> lvl) & 1:
            out = part[lvl] + out
            lvl += 1
        part[lvl] = out
    return out


def _cluster_region_sum(x: torch.Tensor, cs: int, chunk: int) -> torch.Tensor:
    """The region encode's float sum of (P, N) pixel values above P = 4096
    (encode_region_cluster_kernel): CTA i of the cluster's cs takes the
    pixels p = i mod cs (share pixel p' = p / cs), folds the share's chunks
    of `chunk` pixels position by position as a binary counter, then sums
    the positions by the region lane tree of a `chunk`-pixel region (every
    thread of the CTA must hold the same value); the CTAs' sums then meet
    by the halving tree over the ranks (i with i + cs / 2 first). Returns
    (N,)."""
    p, n = x.shape
    shares = x.reshape(p // cs, cs, n).movedim(1, 0)       # (cs, P / cs, N): x[i::cs]
    sums = []
    for share in shares:
        folded = _counter_fold(share.reshape(-1, chunk, n))    # (chunk, N)
        threads = _region_lane_sum(folded)                     # (N, chunk / 8)
        assert torch.equal(threads, threads[:, :1].expand_as(threads))
        sums.append(threads[:, 0])
    ranks = torch.stack(sums)                                  # (cs, N)
    while ranks.shape[0] > 1:
        half = ranks.shape[0] // 2
        ranks = ranks[:half] + ranks[half:]
    return ranks[0]


def _cluster_size(p: int, chunk: int) -> int:
    """The region encode's cluster of C / 4 CTAs (1 to 16) for a region of
    C = P / chunk chunks (launch_region_chunked)."""
    return min(max(p // chunk // 4, 1), 16)


@pytest.mark.parametrize("p,chunk", [
    # levels 4-6: clusters of 1, 4 and 16 CTAs, 4 chunks a CTA
    (16384, 4096), (65536, 4096), (262144, 4096),
    # a share of more chunks than the stage holds (level 7 and up: read
    # from device memory pass by pass), shrunk: chunks of 512 pixels on 2
    # warps, 16 of them a CTA of a 16-CTA cluster
    (131072, 512),
])
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_region_cluster_split_is_tree_sum(p, chunk, n, seed):
    """Above P = 4096 the region encode spreads a region over a cluster of
    cs CTAs, each a subtree of the halving tree (p mod cs) walked as chunks
    folded as a binary counter; the CTAs' sums meet in the tree's last
    levels. The result is ops/fit.py tree_sum bit for bit, on random floats
    with masked (zero) pixels."""
    cs = _cluster_size(p, chunk)
    rng = np.random.default_rng(seed * 31 + p + n)
    x = rng.standard_normal((p, n)) * rng.uniform(1e-3, 1e3, (p, n))
    x[rng.random((p, n)) < 0.2] = 0.0
    x = torch.from_numpy(x.astype(np.float32))
    got = _cluster_region_sum(x, cs, chunk)
    want = tree_sum(x, 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _region_lanes(err, es):
    """(K, P, N) pixel errors of regions of P pixels -> (pixel max, error
    sum) (K, N) as the region encode's lanes give them: each thread over its
    8 pixels t + T j, a block's 8 lanes, then its warp and the region's
    warps (integers: any order; sums wrap)."""
    k, p, n = err.shape
    t = p // 8
    per = _region_threads(err)                             # (K, N, T, 8)
    pm = per.amax(dim=-1)
    be = (per >> es).sum(dim=-1, dtype=torch.int32)        # (K, N, T)
    pm = pm.reshape(k, n, t // 8, 8).amax(dim=-1).amax(dim=-1)
    be = be.reshape(k, n, t // 8, 8).sum(dim=-1, dtype=torch.int32).sum(dim=-1, dtype=torch.int32)
    return pm, be


def _region_inputs(h, w, ch, p, nf):
    """The regions of P pixels of a small image cut by both edges, with the
    plain version's fit, u8 factors and drops (kernels/encode_fixed.py
    encode_blocks_reference)."""
    from chip_smoke import small_image, with_alpha
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.fit import drop_decomposition_axes, fit_blocks
    from limg_tpu_torch.regions import _words

    rgb = small_image(h, w)
    img = rgb if ch == 3 else with_alpha(rgb)
    words = _words(torch.from_numpy(np.ascontiguousarray(img)))
    packed, mask, _ = layout.blockify_words(words, int(p ** 0.5))
    px = torch.stack([layout.unpack_plane(packed, c) for c in range(ch)])
    d = fit_blocks(px, mask, ch)
    f8 = torch.stack([q.to(torch.int32) for q in quantize_factors(*extract_factors(px, d, ch))])
    return px, mask, f8, drop_decomposition_axes(d, nf)


@pytest.mark.parametrize("mode,k", [("ladder", 8), ("ladder", 5), ("ladder", 11),
                                    ("exhaustive", 8), ("guess", 8), ("none", 8)])
@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("p", [64, 256, 1024, 4096])
def test_region_crush_search_is_find_shifts(p, nf, mode, k):
    """The region encode's search (CrushLane::search, every lane of a region
    at level log4(P / 64), the error pre-scale of P) in the kernel's batches
    and peel equals ops/crush.py find_shifts on the regions of a small image
    whose edge regions are cut by both image edges (RGB at P = 64 and 1024,
    RGBA at 256 and 4096)."""
    ch = 4 if p in (256, 4096) else 3
    px, mask, f8, d = _region_inputs(90, 140, ch, p, nf)
    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, num_factors=nf, crush_mode=mode,
                       ladder_k=k)
    got, count = _search_batches(px, mask, f8, d, cfg, _region_lanes, crush.err_scale_shift(p))
    want = crush.force_dropped_axes(crush.find_shifts(px, mask, f8, d, cfg)[0], nf)
    assert torch.equal(got, want)
    assert torch.equal(count, mask.sum(dim=0, dtype=torch.int32))
    assert not mask.all(dim=0).all()                       # regions cut by the edge


def _region_owners(rng, n_squares: int, levels: int) -> torch.Tensor:
    """Owner levels uniform over every region, as the fit gives them: each
    square picks its top level or splits into sub-squares, recursively."""
    def square(lvl):
        if lvl == 0 or rng.random() < 0.3:
            return [lvl] * 4 ** lvl
        return [o for _ in range(4) for o in square(lvl - 1)]

    return torch.tensor([o for _ in range(n_squares) for o in square(levels - 1)],
                        dtype=torch.int32)


@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_region_dist_lane_tree_is_the_owner_pairwise_tree(levels, seed):
    """A region's dist from its blocks' dist_blk: a warp's 4 blocks by xor 8,
    16 (owner >= 1), the warps of a level-2 or level-3 region by the
    exchange's butterflies 1, 2 (, 4, 8) in warp order; blocks outside the
    grid add +0.0 and take their region's owner. Equals OwnerReducer's
    pairwise tree in Morton order."""
    rng = np.random.default_rng(seed * 10 + levels)
    side = 4 ** (levels - 1)
    n = 6 * side
    owner = _region_owners(rng, 6, levels)
    dist_blk = torch.from_numpy((rng.standard_normal(n) ** 2 * rng.uniform(1, 1e6, n))
                                .astype(np.float32))
    outside = torch.from_numpy(rng.random(n) < 0.2)
    dist_blk = torch.where(outside, 0.0, dist_blk)
    ref_owner = torch.where(outside, 0, owner)           # the plain version's padding
    want = OwnerReducer(ref_owner, levels).combine_sum(dist_blk)
    lanes = dist_blk.reshape(-1, 4)[..., None].expand(-1, 4, 8).reshape(-1, 32)
    warp = _butterfly(lanes, (8, 16), torch.add)[:, 0]                 # (warps,)
    got = torch.where(owner == 0, dist_blk, warp.repeat_interleave(4))
    for lvl, g in ((2, 4), (3, 16)):
        if lvl >= levels:
            continue
        x = warp.reshape(-1, g)                          # lane l of the group holds warp l
        x = _butterfly(x, [1 << b for b in range(g.bit_length() - 1)], torch.add)[:, 0]
        got = torch.where(owner == lvl, x.repeat_interleave(4 * g), got)
    keep = ~outside
    assert torch.equal(got[keep].view(torch.int32), want[keep].view(torch.int32))


# ---------------------------------------------------------------------------
# match_neighbors: one thread a block (csrc/coalesce.cu, match_rows<CH, 1>)
# ---------------------------------------------------------------------------

def _one_thread_match(da: Decomposition, db: Decomposition, ch: int) -> torch.Tensor:
    """limg_common.cuh match_rows<CH, 1> for N pairs side by side: the
    inverse lengths once per pair, probes 0..26 folded left in the thread
    and then / 27, skipped (no probe evaluated) where the pair is a fast
    accept or its ratio is out of range."""
    na, lsq_a = _normals(da, ch)
    nb, lsq_b = _normals(db, ch)
    w = _COLOR_DIFF_FACTORS
    avg_diff = (da.avg[0] - db.avg[0]) * (da.avg[0] - db.avg[0]) * w[0]
    for c in range(1, ch):
        avg_diff = avg_diff + (da.avg[c] - db.avg[c]) * (da.avg[c] - db.avg[c]) * w[c]
    sum_a = lsq_a[0] + lsq_a[1] + lsq_a[2]
    sum_b = lsq_b[0] + lsq_b[1] + lsq_b[2]
    range_ok = (sum_a < 200.0 * 3 * ch) & (sum_b < 200.0 * 3 * ch)
    fast = (avg_diff < 16.0 * 3 * ch) & range_ok
    ratio = (sum_a + 1.0) / (sum_b + 1.0)
    ratio_ok = (ratio <= 1.375) & (ratio >= np.float32(1.0 / 1.375))
    probe = ~fast & ratio_ok                              # the threads that run the probes

    def fold(v):
        s = v[0]
        for x in v[1:]:
            s = s + x
        return s

    def il(n):
        return [inv_or_zero(fold([x * x for x in n[k]])) for k in range(3)]

    def factors(col, dd, n, inv):
        lo = [dd[1][c].float() for c in range(ch)]       # dirA_min, then the offsets
        fa = fold([(col[c] - lo[c]) * n[0][c] for c in range(ch)]) * inv[0]
        est = [lo[c] + fa * n[0][c] for c in range(ch)]
        ob = [dd[3][c].float() for c in range(ch)]
        fb = fold([(col[c] - est[c] - ob[c]) * n[1][c] for c in range(ch)]) * inv[1]
        est = [est[c] + fb * n[1][c] for c in range(ch)]
        oc = [dd[5][c].float() for c in range(ch)]
        fc = fold([(col[c] - est[c] - oc[c]) * n[2][c] for c in range(ch)]) * inv[2]
        return fa, fb, fc

    il_a, il_b = il(na), il(nb)
    rl_a, rl_b = [1.0 / x for x in lsq_a], [1.0 / x for x in lsq_b]
    sel = probe.nonzero().flatten()
    mean = torch.zeros_like(sum_a)
    if sel.numel():
        sub = lambda v: v[..., sel]                       # noqa: E731
        na_s = [[sub(x) for x in r] for r in na]
        nb_s = [[sub(x) for x in r] for r in nb]
        da_s = [sub(t) for t in da]
        db_s = [sub(t) for t in db]
        ila, ilb = [sub(x) for x in il_a], [sub(x) for x in il_b]
        rla, rlb = [sub(x) for x in rl_a], [sub(x) for x in rl_b]
        acc = None
        for p in range(27):
            pw = [float(p % 3) * 0.5, float((p // 3) % 3) * 0.5, float((p // 9) % 3) * 0.5]
            col_b = [pw[0] * nb_s[0][c] + pw[1] * nb_s[1][c] + pw[2] * nb_s[2][c]
                     for c in range(ch)]
            col_a = [pw[0] * na_s[0][c] + pw[1] * na_s[1][c] + pw[2] * na_s[2][c]
                     for c in range(ch)]
            fa, fb, fc = factors(col_b, da_s, na_s, ila)
            ga, gb, gc = factors(col_a, db_s, nb_s, ilb)
            dev = fa.abs() * rla[0]
            dev = dev + (0.5 - fb).abs() * 2.0 * rla[1]
            dev = dev + (0.5 - fc).abs() * 2.0 * rla[2]
            dev = dev + ga.abs() * rlb[0]
            dev = dev + (0.5 - gb).abs() * 2.0 * rlb[1]
            dev = dev + (0.5 - gc).abs() * 2.0 * rlb[2]
            acc = dev if acc is None else acc + dev
        mean[sel] = acc / 27.0
    return fast | (probe & (mean < 3.0))


def _decomp(rows: torch.Tensor, ch: int) -> Decomposition:
    return Decomposition(rows[:ch], *(rows[(1 + e) * ch:(2 + e) * ch].to(torch.int32)
                                      for e in range(6)))


def _edge_pairs(ch: int) -> tuple:
    """Row pairs at the predicate's edges: degenerate axes (zero normals),
    flat blocks of two colours (a contract: they match), length-sum ratios
    of exactly 1.375 and 1 / 1.375, and seeded pairs."""
    from chip_smoke import seeded_rows

    rng = np.random.default_rng(ch)
    a = seeded_rows(rng, 400, ch)
    b = a + (rng.random(a.shape) < 0.3) * rng.integers(-6, 7, a.shape)
    a[ch:, :40] = 0                                     # flat a
    b[ch:, :20] = 0                                     # flat b: two flat colours
    a[ch:, 40:60] = a[ch:, 40:60] // 16 * 16            # coarse normals, some zero
    b[3 * ch:5 * ch, 60:80] = b[3 * ch:5 * ch, 60:80][:, :1]    # axis B degenerate
    # sums of the +3-biased weighted lengths: a 21, b 15 -> ratio 22 / 16
    for i, (ra, rb) in enumerate(((21, 15), (15, 21))):
        col = 80 + i
        for r, lsq in ((a, ra), (b, rb)):
            r[ch:, col] = 0
            r[ch, col] = r[2 * ch, col] = 0                 # axis A: n = (1, 1, 0) ...
            r[2 * ch:2 * ch + 2, col] = 1
            if lsq == 21:                                   # ... and axis B too
                r[4 * ch:4 * ch + 2, col] = 1
        a[:ch, col] = b[:ch, col] + 30                      # no fast accept
    return torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))


@pytest.mark.parametrize("ch", [3, 4])
def test_one_thread_probe_loop_is_match_decomps(ch):
    a, b = _edge_pairs(ch)
    da, db = _decomp(a, ch), _decomp(b, ch)
    want, stats = match_decomps(da, db, ch)
    got = _one_thread_match(da, db, ch)
    assert torch.equal(got, want)
    # the edges are there: skipped probes both ways, and the exact ratios
    assert stats["fast_accept"].any() and stats["ratio_reject"].any()
    assert (~stats["fast_accept"] & ~stats["ratio_reject"]).any()
    sums = [sum(_normals(x, ch)[1]) for x in (da, db)]
    ratio = (sums[0] + 1.0) / (sums[1] + 1.0)
    assert (ratio[80] == 1.375) and (ratio[81] == np.float32(1.0 / 1.375))
    assert not stats["ratio_reject"][80:82].any()
    assert want[:20].all()                                # flat pairs of two colours match


@pytest.mark.parametrize("ch", [3, 4])
def test_one_thread_pair_match_is_match_pairs_reference(ch):
    """match_pairs gives each thread one pair of the (7ch, N) stacks, as
    match_neighbors gives it one block: the one-thread probe fold on the
    paired columns is the plain version, on the predicate's edges and on
    seeded pairs (near and unrelated)."""
    from chip_smoke import seeded_rows

    a, b = _edge_pairs(ch)
    rng = np.random.default_rng(30 + ch)
    sa = seeded_rows(rng, 1000, ch)
    sb = sa + (rng.random(sa.shape) < 0.3) * rng.integers(0, 6, sa.shape).astype(np.float32)
    sb[:, ::3] = seeded_rows(rng, 334, ch)
    a = torch.cat([a, torch.from_numpy(sa)], dim=1)
    b = torch.cat([b, torch.from_numpy(sb)], dim=1)
    want = kc.match_pairs_reference(a, b, ch)
    assert torch.equal(_one_thread_match(_decomp(a, ch), _decomp(b, ch), ch), want)
    assert 0 < int(want.sum()) < want.numel()
