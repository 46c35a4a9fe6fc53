"""Block-similarity predicate for region merging, batched.

Reference: limg_encode_3d_matches_sse2 (src/limg.cpp:1137-1275), as the
JAX package has it (limg_tpu/ops/match.py:90, and in the fused kernel
limg_tpu/pallas_kernels/encode_merged.py:376 ``_match_rows``):

1. fast accept: weighted squared avg distance < 16*3*ch AND both weighted
   axis-length sums < 200*3*ch;
2. otherwise reject if the length-sum ratio leaves [1/1.375, 1.375];
3. otherwise project 27 probe colours (half steps along the other frame's
   axes) into both frames and accept when the mean factor deviation < 3.0.

``a`` is the candidate and ``b`` the reference; the test is not symmetric.
Every float sum has one fixed order, which the CUDA kernel
(csrc/encode_merged.cu) follows: channel sums and the six deviation terms
are left folds, and the 27-probe mean is a left fold over probes 0..26
followed by ``/ 27.0``. XLA may add the 27 probes in another order, so a
match bit can differ from the JAX package's where the mean lies within
float rounding of 3.0.
"""

from __future__ import annotations

import torch

from .fit import Decomposition, inv_or_zero

_COLOR_DIFF_FACTORS = (2.0, 4.0, 3.0, 3.0)
_MAX_RATIO = 1.375
_MAX_FACTOR_SUM = 3.0
N_PROBES = 27

# reason bitmask of one merge decision (names as in match_decomps' stats)
MATCH_REASON_BITS = (
    ("fast_accept", 1),
    ("avg_diff_reject", 2),
    ("range_reject", 4),
    ("ratio_reject", 8),
    ("probe_reject", 16),
)


def _fold(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _normals(d: Decomposition, channels: int):
    """Per-axis per-channel float normals + weighted squared lengths with
    the reference's +3 bias."""
    pairs = ((d.dirA_min, d.dirA_max), (d.dirB_offset, d.dirB_mag),
             (d.dirC_offset, d.dirC_mag))
    normals = [[(hi[c] - lo[c]).to(torch.float32) for c in range(channels)]
               for lo, hi in pairs]
    w = _COLOR_DIFF_FACTORS
    len_sq = [3.0 + _fold([n[c] * n[c] * w[c] for c in range(channels)])
              for n in normals]
    return normals, len_sq


def _probe_weights(device) -> list[torch.Tensor]:
    """Three (27, 1) half-step weights; probe p = a + 3b + 9c walks axis A
    fastest."""
    p = torch.arange(N_PROBES, device=device)
    return [(((p // 3 ** k) % 3).to(torch.float32) * 0.5)[:, None] for k in range(3)]


def _probe_factors(colors, d: Decomposition, normals, channels: int):
    """Project (27, N) probe colours onto a decomposition's three axes
    (limg_color_error_state_3d_get_factors with float colours)."""
    na, nb, nc = normals
    ila = inv_or_zero(_fold([x * x for x in na]))
    ilb = inv_or_zero(_fold([x * x for x in nb]))
    ilc = inv_or_zero(_fold([x * x for x in nc]))
    min_a = [d.dirA_min[c].to(torch.float32) for c in range(channels)]
    off_b = [d.dirB_offset[c].to(torch.float32) for c in range(channels)]
    off_c = [d.dirC_offset[c].to(torch.float32) for c in range(channels)]
    fa = _fold([(colors[c] - min_a[c]) * na[c] for c in range(channels)]) * ila
    est = [min_a[c] + fa * na[c] for c in range(channels)]
    fb = _fold([(colors[c] - est[c] - off_b[c]) * nb[c] for c in range(channels)]) * ilb
    est = [est[c] + fb * nb[c] for c in range(channels)]
    fc = _fold([(colors[c] - est[c] - off_c[c]) * nc[c] for c in range(channels)]) * ilc
    return fa, fb, fc


def probe_deviation_mean(da: Decomposition, db: Decomposition, channels: int):
    """(N,) mean over the 27 probes of the cross-projected factor deviation,
    with the lengths it is built from: (dev_mean, len_sq_a, len_sq_b)."""
    na_, lsq_a = _normals(da, channels)
    nb_, lsq_b = _normals(db, channels)
    pw = _probe_weights(da.avg.device)

    def colors(n):
        return [_fold([pw[k] * n[k][c] for k in range(3)]) for c in range(channels)]

    fa, fb, fc = _probe_factors(colors(nb_), da, na_, channels)
    ga, gb, gc = _probe_factors(colors(na_), db, nb_, channels)
    inv_a = [1.0 / x for x in lsq_a]
    inv_b = [1.0 / x for x in lsq_b]
    dev = _fold([
        fa.abs() * inv_a[0],
        (0.5 - fb).abs() * 2.0 * inv_a[1],
        (0.5 - fc).abs() * 2.0 * inv_a[2],
        ga.abs() * inv_b[0],
        (0.5 - gb).abs() * 2.0 * inv_b[1],
        (0.5 - gc).abs() * 2.0 * inv_b[2],
    ])                                                        # (27, N)
    return _fold(list(dev.unbind(0))) / 27.0, lsq_a, lsq_b


def match_decomps(da: Decomposition, db: Decomposition, channels: int):
    """Elementwise merge test between paired decompositions.

    All fields (ch, N). Returns (match (N,) bool, stats dict of per-reason
    (N,) bool arrays, keyed as MATCH_REASON_BITS)."""
    dev_mean, lsq_a, lsq_b = probe_deviation_mean(da, db, channels)
    w = _COLOR_DIFF_FACTORS
    avg_diff_sq = _fold([(da.avg[c] - db.avg[c]) * (da.avg[c] - db.avg[c]) * w[c]
                         for c in range(channels)])
    sum_a = lsq_a[0] + lsq_a[1] + lsq_a[2]
    sum_b = lsq_b[0] + lsq_b[1] + lsq_b[2]
    max_avg = 16.0 * 3.0 * channels
    max_range = 200.0 * 3.0 * channels
    range_ok = (sum_a < max_range) & (sum_b < max_range)
    fast_accept = (avg_diff_sq < max_avg) & range_ok
    ratio = (sum_a + 1.0) / (sum_b + 1.0)
    ratio_ok = (ratio <= _MAX_RATIO) & (ratio >= 1.0 / _MAX_RATIO)
    probe_ok = dev_mean < _MAX_FACTOR_SUM

    match = fast_accept | (ratio_ok & probe_ok)
    stats = {
        "fast_accept": fast_accept,
        "avg_diff_reject": ~fast_accept & (avg_diff_sq >= max_avg),
        "range_reject": ~fast_accept & ~range_ok,
        "ratio_reject": ~fast_accept & ~ratio_ok,
        "probe_reject": ~fast_accept & ratio_ok & ~probe_ok,
    }
    return match, stats


def reason_bits(stats: dict) -> torch.Tensor:
    """match_decomps' stats -> (N,) int32 MATCH_REASON_BITS bitmask."""
    out = torch.zeros_like(stats["fast_accept"], dtype=torch.int32)
    for name, bit in MATCH_REASON_BITS:
        out = out | (stats[name].to(torch.int32) * bit)
    return out
