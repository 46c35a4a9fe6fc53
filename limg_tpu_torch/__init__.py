"""limg_tpu_torch: the limg codec in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``limg_tpu``, which stays the reference. Module
names mirror it (``ops/layout.py`` is ``limg_tpu/ops/layout.py``'s
counterpart, and so on); tensors keep its layouts. This package never
imports JAX. Public entry points take an explicit ``device``: "cuda" runs
the kernels, "cpu" their plain PyTorch versions.

Ported so far: the fixed-grid encode (``encode_image``) and the
quadtree-merged encode with run coalescing, the codec's default
(``encode_image_merged``), on the fused path at 2-4 levels (the default)
and on the dense path (``fused=False``, every 1-level encode and every
encode of 5 levels or more; ``encode_image_merged_device``), under the
match policy (the fused stages
``fused_merged_pre`` / ``fused_merged_finish``) and the RD policy
(``merge_policy="rd"``; ``fused_rd_pre`` / ``fused_rd_finish``,
``rd_merge_keep``), the LTP1 stream of a merged encode (``serialize`` /
``deserialize``, ``bitstream.serialize_from_state``, on the host runtime
of ``native.py``), the legacy 1-factor encoder (``encode_legacy``), and
corpus and multi-device encode over a mesh of devices driven by one
process (``parallel.mesh``: ``encode_corpus_sharded``, ``_merged``,
``_mixed``, ``encode_image_blocks_sharded``; ``parallel.corpus``:
``encode_corpus_streaming`` on the native staging pool). See ROADMAP.md
for the rest.
"""

from .bitstream import deserialize, serialize
from .config import BLOCK_SIZE, EncodeConfig
from .encoder import encode_image, encode_image_device, encode_perf_step
from .legacy import LegacyConfig, encode_legacy
from .ops.error import psnr as compare_psnr
from .regions import (auto_run_capacity, encode_image_merged, encode_image_merged_device,
                      encode_image_merged_fused_device, encode_image_merged_rd_device,
                      fused_merged_finish, fused_merged_pre, fused_rd_finish, fused_rd_pre,
                      rd_merge_keep)

__all__ = [
    "EncodeConfig",
    "BLOCK_SIZE",
    "encode_image",
    "encode_image_device",
    "encode_perf_step",
    "encode_image_merged",
    "encode_image_merged_device",
    "encode_image_merged_fused_device",
    "fused_merged_pre",
    "fused_merged_finish",
    "encode_image_merged_rd_device",
    "fused_rd_pre",
    "fused_rd_finish",
    "rd_merge_keep",
    "auto_run_capacity",
    "compare_psnr",
    "serialize",
    "deserialize",
    "LegacyConfig",
    "encode_legacy",
]
