"""Perceptually weighted error model and PSNR, batched.

Reference semantics: limg_color_error (src/limg_internal.h:376-410) --
squared error with channel weights selected by the squared red difference:
{2,4,3,3} when (a.r - b.r)^2 < 0x4000, else {3,4,2,3}. PSNR per
limg_compare (src/limg.cpp:2455-2491).
"""

from __future__ import annotations

import math

import torch

_W_LO = (2, 4, 3, 3)
_W_HI = (3, 4, 2, 3)


def weighted_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Weighted squared error. ``a``/``b``: (ch, ...) int32. Returns (...) i32.

    The per-pixel maximum is 255^2 * 12 = 780300, well inside int32.
    """
    d = a - b
    d2 = d * d
    red_lo = d2[0] < 0x4000
    err = torch.zeros_like(d2[0])
    for i in range(a.shape[0]):
        w = torch.where(red_lo, _W_LO[i], _W_HI[i]).to(d2.dtype)
        err = err + d2[i] * w
    return err


def max_possible_error(channels: int) -> int:
    """Weighted error of black vs white: 255^2 * sum of high-red weights."""
    return 255 * 255 * sum(_W_HI[:channels])


def psnr(img_a: torch.Tensor, img_b: torch.Tensor, channels: int):
    """Weighted PSNR between (H, W, >=ch) uint8 images -> (psnr, mse) floats.

    The error total is an exact int64 sum.
    """
    a = img_a[..., :channels].to(torch.int32).permute(2, 0, 1)
    b = img_b[..., :channels].to(torch.int32).permute(2, 0, 1)
    total = int(weighted_error(a, b).sum(dtype=torch.int64))
    mse = total / (img_a.shape[0] * img_a.shape[1])
    return 10.0 * math.log10(max_possible_error(channels) / mse), mse
