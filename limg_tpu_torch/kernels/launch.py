"""The launch seam under the kernel wrappers.

Every wrapper of this package loads its library, routes a tensor by its
device and launches a C entry point through this module:

- ``library(name)``: the built ``csrc/<name>.cu`` with the argument types
  of each of its entries in ``SIGNATURES`` declared, every entry returning
  the C int status;
- ``on_card(device)``: False on the CPU (the wrapper runs its plain
  version), True on a CUDA device (it launches), raises on any other;
- ``call(lib, fn_name, kernel, device, *args)``: the entry on the device's
  current stream, raising on a non-zero status, counted in ``launches``
  under ``kernel``, the name the profiler and the benchmark print
  (``encode_fixed_p64``, ``encode_region_p{P}``, ``segment_encode_p{P}``,
  ``fit_levels``, ``owner_crush``, ...).

It also holds what the wrappers share of the kernels' arguments and
outputs: the crush settings (``crush_args``) and the packing of decoded
channels into words (``pack_decoded``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..config import EncodeConfig
from ..ops.layout import to_int32_bits

PTR, I32, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32

# the crush search's mode as the kernels take it; an unknown mode is the
# ladder, as in ops/crush.py
CRUSH_MODES = {"none": 0, "ladder": 1, "exhaustive": 2, "guess": 3}

# kernel launches since the last reset, by kernel name (read and reset by
# callers)
launches: collections.Counter = collections.Counter()

# {library: {C entry: argument types}}; each entry's last argument is the
# stream, which ``call`` appends
_MERGED = {"limg_fit_levels": [PTR] + [I32] * 5 + [PTR] * 8,
           "limg_owner_crush": [PTR] + [I32] * 10 + [U32] + [PTR] * 10}
SIGNATURES = {
    "encode_fixed": {"limg_encode_fixed_p64": [PTR, PTR] + [I32] * 8 + [U32] + [PTR] * 7},
    "encode_region": {"limg_encode_region": [PTR, PTR] + [I32] * 9 + [U32] + [PTR] * 7},
    "fixed_planes": {"limg_fixed_planes": [PTR] * 2 + [I32] * 5 + [PTR] * 4},
    "crush_eval": {"limg_crush_eval": [PTR] * 6 + [I32] * 4 + [PTR] * 3},
    "seg_fold": {"limg_seg_sum_fold": [PTR] * 3 + [I32] * 3 + [PTR] * 2},
    "encode_merged": _MERGED,
    # the natural layout's two entries take the merged ones' arguments
    "encode_natural": {f"{name}_natural": argtypes for name, argtypes in _MERGED.items()},
    "coalesce": {"limg_match_pairs": [PTR, PTR, I32, I32, PTR, PTR],
                 "limg_match_neighbors": [PTR, I32, I32, I32, PTR, PTR, PTR],
                 "limg_seg_scan": [PTR, I32, PTR],
                 "limg_segment_encode": [PTR] * 4 + [I32] * 9 + [U32] + [PTR] * 10},
    "segment_region": {"limg_segment_encode_region": [PTR] * 4 + [I32] * 9 + [U32] + [PTR] * 11},
}

_libraries: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


def library(name: str) -> ctypes.CDLL:
    """The built kernel library ``name``, loaded once, with the argument
    types of each of its C entries in ``SIGNATURES`` declared."""
    lib = _libraries.get(name)
    if lib is None:
        from .build import load_library

        lib = load_library(name)
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = I32
        lib.limg_cuda_error_string.argtypes = [I32]
        lib.limg_cuda_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def on_card(device) -> bool:
    """False for a CPU device, True for a CUDA one; raises for any other."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(f"no kernel for device {device}")
    return True


def call(lib: ctypes.CDLL, fn_name: str, kernel: str, device, *args) -> None:
    """Launch ``fn_name`` of ``lib`` with ``args`` on the current stream of
    ``device``; raise on a failed launch, else count it under ``kernel``."""
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{lib.limg_cuda_error_string(rc).decode()} ({rc})")
    launches[kernel] += 1


def crush_args(cfg: EncodeConfig, key: int) -> tuple:
    """The crush settings the kernels take, in their order: mode (0 without
    crush bits), dithering, ladder K, num_factors, the pixel and block
    error bounds, and the 32-bit dither ``key``."""
    return (CRUSH_MODES.get(cfg.crush_mode, 1) if cfg.crush_bits else 0,
            int(cfg.dithering and cfg.crush_bits), cfg.ladder_k, cfg.num_factors,
            cfg.max_pixel_bit_crush_error, cfg.max_block_bit_crush_error, key)


def pack_decoded(dec: torch.Tensor, channels: int) -> torch.Tensor:
    """(ch, P, NB) decoded channels -> packed words, alpha 0xFF for RGB."""
    words = dec[0].to(torch.int64) + (dec[1].to(torch.int64) << 8) + (dec[2].to(torch.int64) << 16)
    words = words + ((dec[3].to(torch.int64) << 24) if channels == 4 else 0xFF000000)
    return to_int32_bits(words)
