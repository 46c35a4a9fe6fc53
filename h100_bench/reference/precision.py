"""The control's lower precision: every float sum of the reference rounded
to bfloat16.

The codec states float32 arithmetic (the fit, the factors, the weighted
error). The control of the benchmark's check is this reference computed one
precision below, bfloat16: inside ``lowered()`` every step of a float sum
over a region's pixels (``ops.fit.tree_sum``) and every channel dot
(``ops.fit.channel_dot``) rounds its result to bfloat16. Outside it nothing
changes.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_LOW = contextvars.ContextVar("bfloat16_sums", default=False)


@contextlib.contextmanager
def lowered():
    """Round every float sum of the reference to bfloat16 inside the block."""
    token = _LOW.set(True)
    try:
        yield
    finally:
        _LOW.reset(token)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or inside ``lowered()`` a float ``x`` rounded to bfloat16."""
    if _LOW.get() and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x
