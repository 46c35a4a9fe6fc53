"""The benchmark's plain reference: a frozen copy of the port's plain route.

Copied from ``limg_tpu_torch`` (its Python and its ``*_reference``
functions; no ``csrc/``, no ``kernels/build.py``), with every ``*_kernel``
wrapper sent to its plain version on every device, so it runs in plain
PyTorch on the card as on the CPU. It imports neither JAX nor the JAX
package nor anything of ``limg_tpu_torch``, and a later change to the port
does not change it. ``precision.lowered()`` computes it in bfloat16 sums:
the control of the benchmark's check.
"""

from .config import EncodeConfig
from .encoder import encode_image_device
from .precision import lowered
from .regions import auto_run_capacity, encode_image_merged, fused_merged_pre

__all__ = ["EncodeConfig", "encode_image_device", "encode_image_merged", "fused_merged_pre",
           "auto_run_capacity", "lowered"]
