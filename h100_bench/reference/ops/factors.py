"""Batched factor extraction: project every pixel onto its block's axes.

Reference: limg_color_error_state_3d_get_factors
(src/limg_factorization.h:9-96). The projection uses the rounded int16
endpoints: normalA = dirA_max - dirA_min etc., with zero-length normals
giving factor 0. Quantization to u8 rounds half to even like the
reference's SSE path (_mm_cvtps_epi32, src/limg_factorization.h:126).
Channel dot products are left folds, as in the CUDA kernels. The endpoints
are per block; for a quadtree region they are the region's, broadcast to
each member block (ops/fit.py fit_regions).
"""

from __future__ import annotations

import torch

from .fit import Decomposition, channel_dot, inv_or_zero


def axis_normals(d: Decomposition):
    """Float normals (ch, NB) and inverse squared lengths (NB,), 0 for
    degenerate axes."""
    na = (d.dirA_max - d.dirA_min).to(torch.float32)
    nb = (d.dirB_mag - d.dirB_offset).to(torch.float32)
    nc = (d.dirC_mag - d.dirC_offset).to(torch.float32)

    def inv_sq(v):
        return inv_or_zero(channel_dot(v, v))

    return na, nb, nc, inv_sq(na), inv_sq(nb), inv_sq(nc)


def extract_factors(px_u8: torch.Tensor, d: Decomposition, channels: int):
    """Sequential per-pixel projections -> float factors.

    ``px_u8``: (>=ch, P, NB) uint8. Returns (fa, fb, fc), each (P, NB) f32.
    """
    px = px_u8[:channels].to(torch.float32)
    na, nb, nc, ila, ilb, ilc = axis_normals(d)
    min_a = d.dirA_min.to(torch.float32)[:, None, :]
    off_b = d.dirB_offset.to(torch.float32)[:, None, :]
    off_c = d.dirC_offset.to(torch.float32)[:, None, :]
    na, nb, nc = na[:, None, :], nb[:, None, :], nc[:, None, :]

    fa = channel_dot(px - min_a, na) * ila
    est = min_a + fa[None] * na
    fb = channel_dot(px - est - off_b, nb) * ilb
    est = est + fb[None] * nb
    fc = channel_dot(px - est - off_c, nc) * ilc
    return fa, fb, fc


def quantize_factors(fa, fb, fc):
    """float factors -> u8 planes: clamp(rint(f * 255), 0, 255)."""

    def q(f):
        return torch.clamp(torch.round(f * 255.0), 0, 255).to(torch.uint8)

    return q(fa), q(fb), q(fc)
