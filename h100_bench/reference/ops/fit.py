"""Batched 3-axis sequential linear fit over all blocks at once.

The reference's per-block fit (src/limg_factorization.h:796-1247) as
float32 passes over the ``(ch, P, NB)`` tensor of every block. Ragged edge
blocks are handled with a validity mask.

Every float sum has one fixed order, which the CUDA kernel
(csrc/region_encode.cuh) follows too, so the two agree bit for bit:

- over the P pixels of a block or region (64 for an 8x8 block; 256, 1024
  or 4096 for the RD policy's 16x16, 32x32 and 64x64 regions), a halving
  tree ``x[:n/2] + x[n/2:]`` (``tree_sum``; in a kernel, the in-thread top
  levels, then shared memory and butterfly shuffles);
- over channels, a left fold ``c0 + c1 + c2 (+ c3)``;
- every product and sum rounds on its own: no fused multiply-add, and
  ``1 / sqrt(x)`` in place of an approximate rsqrt.

The quadtree levels fit regions of 4^l blocks (``fit_regions``): each sum
is the block's sum in the natural layout's order, then a tree across the
region's blocks (ops/reduce.py). ``fit_blocks`` is the one-block-region
case.

The JAX package sums in XLA's order, so rounded endpoints can differ from
it by 1 on a few blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..precision import rounded


class Decomposition(NamedTuple):
    """Per-block fit result. All fields (ch, NB); endpoints int32."""

    avg: torch.Tensor        # float32
    dirA_min: torch.Tensor
    dirA_max: torch.Tensor
    dirB_offset: torch.Tensor
    dirB_mag: torch.Tensor
    dirC_offset: torch.Tensor
    dirC_mag: torch.Tensor


ENDPOINT_FIELDS = Decomposition._fields[1:]

_TINY = 1e-38
_BIG = 3.4e38


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power-of-two length) by repeated halving."""
    n = x.shape[dim]
    while n > 1:
        if n % 2:
            raise ValueError(f"tree_sum needs a power-of-two length, got {n}")
        n //= 2
        x = rounded(x.narrow(dim, 0, n) + x.narrow(dim, n, n))
    return x.squeeze(dim)


def channel_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Left fold sum_c u[c] * v[c] over the leading channel axis."""
    acc = rounded(u[0] * v[0])
    for c in range(1, u.shape[0]):
        acc = rounded(acc + u[c] * v[c])
    return acc


def inv_or_zero(x: torch.Tensor) -> torch.Tensor:
    """1 / x where x > 0, else 0."""
    return torch.where(x > 0, 1.0 / torch.clamp(x, min=_TINY), 0.0)


def _fast_round(x: torch.Tensor) -> torch.Tensor:
    """limg_fast_round_int16: floor(x + 0.5) (src/limg_internal.h:689-692)."""
    return torch.floor(x + 0.5).to(torch.int32)


def drop_decomposition_axes(d: Decomposition, num_factors: int) -> Decomposition:
    """Zero the endpoints of statically dropped axes (reduced-factor modes).

    Dropping axis k is the shift=8 encoding. Zeroing the endpoints before
    the crush search makes every candidate evaluation include the
    drop-induced error."""
    if num_factors >= 3:
        return d
    zero = torch.zeros_like(d.dirC_offset)
    d = d._replace(dirC_offset=zero, dirC_mag=zero)
    if num_factors < 2:
        d = d._replace(dirB_offset=zero, dirB_mag=zero)
    return d


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on any device, as the kernels'
    ``sqrtf``. PyTorch's CPU float32 sqrt is not on every build (torch
    2.13.0+cpu: an ulp off on ~0.7% of inputs, and up to 3e-4 relative on
    a worker thread's first call in a process), so the CPU takes NumPy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def _signed_unit_mean(v: torch.Tensor, mask: torch.Tensor,
                      inv_count: torch.Tensor, red) -> torch.Tensor:
    """Mean over pixels of sign-corrected unit vectors.

    ``v``: (ch, P, NB); the sign comes from the first largest-|component|
    channel (src/limg_factorization.h:816-851). Zero vectors and masked-out
    pixels contribute nothing. Returns (ch, NB) region means.
    """
    len_sq = channel_dot(v, v)
    best_abs = v[0].abs()
    lead = v[0]
    for j in range(1, v.shape[0]):
        a = v[j].abs()
        take = a > best_abs
        best_abs = torch.where(take, a, best_abs)
        lead = torch.where(take, v[j], lead)
    inv_len = torch.where(
        len_sq > 0, 1.0 / _sqrt(torch.clamp(len_sq, min=_TINY)), 0.0)
    inv_len = torch.where(lead < 0, -inv_len, inv_len) * mask
    return red.sum(v * inv_len) * inv_count


def _project(v: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Per-pixel projection factor of v (ch, P, NB) onto direction (ch, NB):
    dot / |d|^2, and 0 for a zero direction. Returns (P, NB)."""
    dot = channel_dot(v, direction[:, None, :])
    return dot * inv_or_zero(channel_dot(direction, direction))


def fit_regions(px_u8: torch.Tensor, mask: torch.Tensor, channels: int, red):
    """Fit every region of the reducer ``red`` (ops/reduce.py).

    ``px_u8``: (>=ch, P, NB) uint8 or int; ``mask``: (P, NB) bool. Returns
    (Decomposition, region pixel counts int32), each region's values
    broadcast to its blocks, (..., NB), or per segment, (..., S), for a
    ``ScatterReducer`` (whose ``to_blocks`` takes them to the blocks for the
    per-pixel passes; every other reducer's is the identity).
    """
    px = px_u8[:channels].to(torch.float32)
    m = mask.to(torch.float32)
    blk = red.to_blocks
    count = red.sum(mask.to(torch.int32))
    inv_count = 1.0 / torch.clamp(count.to(torch.float32), min=1.0)

    avg = red.sum(px * m) * inv_count                      # (ch, NB)
    avg_b = blk(avg)[:, None, :]
    corrected = (px - avg_b) * m
    dir_a = _signed_unit_mean(corrected, m, inv_count, red)
    dir_a_b = blk(dir_a)

    fac_a = _project(corrected, dir_a_b) * m
    est = avg_b + fac_a[None] * dir_a_b[:, None, :]
    resid_a = (px - est) * m
    dir_b = _signed_unit_mean(resid_a, m, inv_count, red)
    dir_b_b = blk(dir_b)

    fac_b = _project(resid_a, dir_b_b) * m
    est_b = est + fac_b[None] * dir_b_b[:, None, :]
    resid_ab = (px - est_b) * m
    if channels == 3:
        # dirC = cross(dirA, dirB) (src/limg_factorization.h:946)
        dir_c = torch.stack([
            dir_a[1] * dir_b[2] - dir_a[2] * dir_b[1],
            dir_a[2] * dir_b[0] - dir_a[0] * dir_b[2],
            dir_a[0] * dir_b[1] - dir_a[1] * dir_b[0],
        ])
    else:
        # R^4: a third residual sweep (src/limg_factorization.h:1002-1247)
        dir_c = _signed_unit_mean(resid_ab, m, inv_count, red)
    fac_c = _project(resid_ab, blk(dir_c)) * m

    # empty regions (segments of padding lanes): the +-BIG sentinels become
    # 0 (limg_tpu/ops/segments.py:345-349); such a region is flat, so its
    # endpoints are 0 either way
    empty = count <= 0

    def minmax(fac):
        return (torch.where(empty, 0.0, red.min(torch.where(mask, fac, _BIG))),
                torch.where(empty, 0.0, red.max(torch.where(mask, fac, -_BIG))))

    mn_a, mx_a = minmax(fac_a)
    mn_b, mx_b = minmax(fac_b)
    mn_c, mx_c = minmax(fac_c)

    # Flat regions (dirA == 0): endpoints collapse to avg and B/C vanish
    # (src/limg_factorization.h:874-882).
    flat = channel_dot(dir_a, dir_a) <= 0.0

    def z(x):
        return torch.where(flat, 0.0, x)

    return Decomposition(
        avg=avg,
        dirA_min=_fast_round(avg + mn_a * dir_a),
        dirA_max=_fast_round(avg + mx_a * dir_a),
        dirB_offset=_fast_round(z(mn_b * dir_b)),
        dirB_mag=_fast_round(z(mx_b * dir_b)),
        dirC_offset=_fast_round(z(mn_c * dir_c)),
        dirC_mag=_fast_round(z(mx_c * dir_c)),
    ), count


def fit_blocks(px_u8: torch.Tensor, mask: torch.Tensor, channels: int) -> Decomposition:
    """Fit every block or region of P pixels. ``px_u8``: (>=ch, P, NB) uint8;
    ``mask``: (P, NB) bool."""
    from .reduce import BlockReducer

    return fit_regions(px_u8, mask, channels, BlockReducer())[0]
