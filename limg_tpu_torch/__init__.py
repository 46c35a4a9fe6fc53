"""limg_tpu_torch: the limg codec in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``limg_tpu``, which stays the reference. Module
names mirror it (``ops/layout.py`` is ``limg_tpu/ops/layout.py``'s
counterpart, and so on); tensors keep its layouts. This package never
imports JAX. Public entry points take an explicit ``device``: "cuda" runs
the kernels, "cpu" their plain PyTorch versions.

Ported so far: the fixed-grid encode (``encode_image``) and the
quadtree-merged encode without run coalescing
(``encode_image_merged(..., coalesce=False)``). See ROADMAP.md for the rest.
"""

from .config import BLOCK_SIZE, EncodeConfig
from .encoder import encode_image, encode_image_device, encode_perf_step
from .ops.error import psnr as compare_psnr
from .regions import encode_image_merged, encode_image_merged_fused_device

__all__ = [
    "EncodeConfig",
    "BLOCK_SIZE",
    "encode_image",
    "encode_image_device",
    "encode_perf_step",
    "encode_image_merged",
    "encode_image_merged_fused_device",
    "compare_psnr",
]
