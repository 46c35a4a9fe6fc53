"""The reduction orders of the quadtree fit kernel (csrc/encode_merged.cuh)
and the segment kernel (csrc/coalesce.cu), emulated lane by lane in torch
and held bit-equal to the plain versions' orders (ops/reduce.py,
ops/segments.py), on the CPU; and the segment kernel's short path for
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
  segment: the doubling scan's fwd + bwd - x.
"""

import numpy as np
import pytest
import torch

from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import coalesce as kc
from limg_tpu_torch.ops.fit import tree_sum
from limg_tpu_torch.ops.reduce import nat_block_sum, pairwise_tree
from limg_tpu_torch.ops.segments import seg_mixed_all

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
