"""limg_tpu_torch: the limg codec in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``limg_tpu``, which stays the reference. Module
names mirror it (``ops/layout.py`` is ``limg_tpu/ops/layout.py``'s
counterpart, and so on); tensors keep its layouts. This package never
imports JAX. Public entry points take an explicit ``device``: "cuda" runs
the kernels, "cpu" their plain PyTorch versions.

Ported so far: the fixed-grid encode (``encode_image``). See ROADMAP.md for
the rest.
"""

from .config import BLOCK_SIZE, EncodeConfig
from .encoder import encode_image, encode_image_device, encode_perf_step
from .ops.error import psnr as compare_psnr

__all__ = [
    "EncodeConfig",
    "BLOCK_SIZE",
    "encode_image",
    "encode_image_device",
    "encode_perf_step",
    "compare_psnr",
]
