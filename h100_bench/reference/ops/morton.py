"""Morton (Z-order) block order of the quadtree's plain version.

The JAX package lays the level-0 blocks out in Morton order
(limg_tpu/pallas_kernels/encode_merged.py:64 ``morton_perm``, :226
``morton_mask``) so that every aligned 2^l x 2^l square of blocks is a
contiguous group of 4^l lanes. The port's plain version
(kernels/encode_merged.py) works in the same order, which fixes the order of
its cross-block reductions (ops/reduce.py). The CUDA kernels read the
row-major image and need no relayout: a CTA's warps are the blocks of one
top-level square in this order.
"""

from __future__ import annotations

import numpy as np
import torch


def morton_perm(blocks_y: int, blocks_x: int, levels: int):
    """Morton permutation of a block grid.

    Returns (perm (NBP,) int64, blocks_y_padded, blocks_x_padded):
    ``perm[m]`` is the row-major block index at Morton position ``m``, or -1
    for a padding block. The grid is padded to multiples of
    g = 2^(levels-1); position = row-major square index * g^2 +
    bit-interleave(y % g, x % g) with x in the even bits, so the four
    children of a parent come in (0,0), (0,1), (1,0), (1,1) order.
    """
    g = 1 << (levels - 1)
    byp = -(-blocks_y // g) * g
    bxp = -(-blocks_x // g) * g
    yy, xx = np.mgrid[0:byp, 0:bxp]
    sc = (yy >> (levels - 1)) * (bxp // g) + (xx >> (levels - 1))
    local = np.zeros_like(yy)
    for b in range(levels - 1):
        local |= ((xx >> b) & 1) << (2 * b)
        local |= ((yy >> b) & 1) << (2 * b + 1)
    key = sc * (g * g) + local
    orig = np.where((yy < blocks_y) & (xx < blocks_x), yy * blocks_x + xx, -1)
    perm = np.empty(byp * bxp, np.int64)
    perm[key.ravel()] = orig.ravel()
    return perm, byp, bxp


def morton_mask(h: int, w: int, levels: int, device="cpu") -> torch.Tensor:
    """(64, NBP) bool pixel validity mask in Morton block order."""
    g = 1 << (levels - 1)
    lv = levels - 1
    by, bx = -(-h // 8), -(-w // 8)
    byp, bxp = -(-by // g) * g, -(-bx // g) * g
    p = torch.arange(byp * bxp, device=device)[None, :]
    pix = torch.arange(64, device=device)[:, None]
    sc = p >> (2 * lv)
    yb = torch.zeros_like(p)
    xb = torch.zeros_like(p)
    for b in range(lv):
        yb = yb | (((p >> (2 * b + 1)) & 1) << b)
        xb = xb | (((p >> (2 * b)) & 1) << b)
    row = ((sc // (bxp // g)) * g + yb) * 8 + (pix >> 3)
    col = ((sc % (bxp // g)) * g + xb) * 8 + (pix & 7)
    return (row < h) & (col < w)


class MortonOrder:
    """Row-major <-> Morton block order for one grid, on one device."""

    def __init__(self, blocks_y: int, blocks_x: int, levels: int, device):
        perm, self.blocks_y_padded, self.blocks_x_padded = morton_perm(
            blocks_y, blocks_x, levels)
        valid = perm >= 0
        self.num_blocks = blocks_y * blocks_x
        self.num_padded = perm.size
        self.perm = torch.from_numpy(perm).to(device)
        self._valid = torch.from_numpy(np.nonzero(valid)[0]).to(device)
        # Morton position of each row-major block
        mpos = np.zeros(self.num_blocks, np.int64)
        mpos[perm[valid]] = np.nonzero(valid)[0]
        self.mpos = torch.from_numpy(mpos).to(device)

    def embed(self, rows: torch.Tensor) -> torch.Tensor:
        """(..., NB) row-major -> (..., NBP) Morton order, padding zero."""
        out = rows.new_zeros((*rows.shape[:-1], self.num_padded))
        out[..., self._valid] = rows[..., self.perm[self._valid]]
        return out

    def restore(self, rows_m: torch.Tensor) -> torch.Tensor:
        """(..., NBP) Morton order -> (..., NB) row-major."""
        return rows_m[..., self.mpos]
