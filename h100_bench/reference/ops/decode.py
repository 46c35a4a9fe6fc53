"""Integer reconstruction from crushed factor planes, batched.

Reference: limg_decode_block_from_factors_3d_ (src/limg_decode.h:238-324):

- dequantization by bit replication: f_dec = q * DEQUANT_MULT[s];
- per-axis contribution min + ((f_dec * normal + 128) >> 8), where ``>>``
  is arithmetic (a floor for negative products), summed over the three
  axes and clamped to u8;
- shift > 7 drops the factor: its normal is zeroed; axes B/C also zero
  their offset while axis A keeps dirA_min.

Shifts may carry leading batch dimensions (one triple per candidate in
the crush search); the decomposition broadcasts against them.
"""

from __future__ import annotations

import torch

from .fit import Decomposition

# (1 << s) + bit-replication bias for s = 0..7; slot 8 (dropped) unused.
DEQUANT_MULT = (1, 2, 4, 8, 17, 36, 85, 255, 0)


def dequant_mult(s_eff: torch.Tensor) -> torch.Tensor:
    """DEQUANT_MULT[s_eff] for int32 shifts in [0, 8]."""
    table = torch.tensor(DEQUANT_MULT, dtype=torch.int32, device=s_eff.device)
    return table[s_eff.long()]


def decode_params(d: Decomposition, shifts: torch.Tensor, channels: int):
    """Normals/mins with factor-drop rules applied.

    ``shifts``: (..., 3, NB) int32. Returns (normals, mins), each
    (..., 3, ch, NB) int32.
    """
    normals = torch.stack([
        d.dirA_max - d.dirA_min,
        d.dirB_mag - d.dirB_offset,
        d.dirC_mag - d.dirC_offset,
    ])[:, :channels]
    mins = torch.stack([d.dirA_min, d.dirB_offset, d.dirC_offset])[:, :channels]
    dropped = (shifts > 7)[..., None, :]                     # (..., 3, 1, NB)
    normals = torch.where(dropped, 0, normals)
    keep_min = torch.tensor([True, False, False], device=shifts.device).reshape(3, 1, 1)
    mins = torch.where(dropped & ~keep_min, 0, mins)
    return normals, mins


def decode_blocks(q: torch.Tensor, shifts: torch.Tensor, d: Decomposition,
                  channels: int) -> torch.Tensor:
    """Reconstruct pixels.

    ``q``: (..., 3, P, NB) int32 crushed factors; ``shifts``: (..., 3, NB)
    int32. Returns (..., ch, P, NB) int32 in [0, 255].
    """
    normals, mins = decode_params(d, shifts, channels)
    f_dec = q * dequant_mult(torch.clamp(shifts, max=8))[..., None, :]   # (..., 3, P, NB)
    est = 0
    for k in range(3):
        prod = f_dec[..., k, None, :, :] * normals[..., k, :, None, :] + 128
        est = est + mins[..., k, :, None, :] + (prod >> 8)           # (..., ch, P, NB)
    return torch.clamp(est, 0, 255)
