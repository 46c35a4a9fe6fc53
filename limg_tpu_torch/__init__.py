"""limg_tpu_torch: the limg codec in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``limg_tpu``, which stays the reference. Module
names mirror it (``ops/layout.py`` is ``limg_tpu/ops/layout.py``'s
counterpart, and so on); tensors keep its layouts. This package never
imports JAX. Public entry points take an explicit ``device``: "cuda" runs
the kernels, "cpu" their plain PyTorch versions.

Ported so far: the fixed-grid encode (``encode_image``) and the
quadtree-merged encode with run coalescing, the codec's default
(``encode_image_merged``, match policy, 2-4 levels; its stages
``fused_merged_pre`` / ``fused_merged_finish``). See ROADMAP.md for the
rest.
"""

from .config import BLOCK_SIZE, EncodeConfig
from .encoder import encode_image, encode_image_device, encode_perf_step
from .ops.error import psnr as compare_psnr
from .regions import (auto_run_capacity, encode_image_merged,
                      encode_image_merged_fused_device, fused_merged_finish,
                      fused_merged_pre)

__all__ = [
    "EncodeConfig",
    "BLOCK_SIZE",
    "encode_image",
    "encode_image_device",
    "encode_perf_step",
    "encode_image_merged",
    "encode_image_merged_fused_device",
    "fused_merged_pre",
    "fused_merged_finish",
    "auto_run_capacity",
    "compare_psnr",
]
