"""Fixed-grid block encode: the CUDA kernel's wrapper and its plain version.

``encode_blocks_kernel`` takes the arguments of the JAX package's
``encode_blocks_pallas`` (limg_tpu/pallas_kernels/encode_fixed.py:808) at
P = 64 and returns its outputs in its layouts:

    shifts (3, NB) i32, q_packed (64, NB) i32, dec_packed (64, NB) i32,
    dist (1, NB) f32 [, dirA_min, dirA_max, dirB_offset, dirB_mag,
    dirC_offset, dirC_mag (ch, NB) i32, avg (ch, NB) f32]

On a CUDA tensor it launches ``csrc/encode_fixed.cu`` (built at first use)
and raises if the launch fails; on a CPU tensor it runs
``encode_blocks_reference``, which composes the plain ops of
``limg_tpu_torch.ops`` in the kernel's arithmetic order. The two agree bit
for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import BLOCK_AREA, EncodeConfig
from ..ops.crush import find_shifts
from ..ops.decode import decode_blocks
from ..ops.dither import dither_crush, dither_key
from ..ops.error import weighted_error
from ..ops.factors import extract_factors, quantize_factors
from ..ops.fit import (ENDPOINT_FIELDS, drop_decomposition_axes, fit_blocks,
                       tree_sum)
from ..ops.layout import to_int32_bits, unpack_plane

# kernel launches since the last reset (read and reset by callers)
launches = 0

_CRUSH_MODES = {"none": 0, "ladder": 1, "exhaustive": 2, "guess": 3}


def _check_inputs(packed: torch.Tensor, mask: torch.Tensor) -> None:
    if packed.ndim != 2 or packed.dtype != torch.int32:
        raise ValueError(f"packed must be (P, NB) int32, got {tuple(packed.shape)} {packed.dtype}")
    if packed.shape[0] != BLOCK_AREA:
        raise ValueError(f"only P = {BLOCK_AREA} (8x8 blocks) is ported, got P = {packed.shape[0]}")
    if mask.shape != packed.shape or mask.dtype != torch.bool:
        raise ValueError(f"mask must be {tuple(packed.shape)} bool, got {tuple(mask.shape)} {mask.dtype}")
    if mask.device != packed.device:
        raise ValueError(f"packed on {packed.device} but mask on {mask.device}")


def _pack_decoded(dec: torch.Tensor, channels: int) -> torch.Tensor:
    """(ch, P, NB) decoded channels -> packed words, alpha 0xFF for RGB."""
    words = dec[0].to(torch.int64) + (dec[1].to(torch.int64) << 8) + (dec[2].to(torch.int64) << 16)
    words = words + ((dec[3].to(torch.int64) << 24) if channels == 4 else 0xFF000000)
    return to_int32_bits(words)


def encode_blocks_reference(packed: torch.Tensor, mask: torch.Tensor,
                            cfg: EncodeConfig, seed: int,
                            emit_endpoints: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    _check_inputs(packed, mask)
    ch = cfg.channels
    px = torch.stack([unpack_plane(packed, c) for c in range(ch)])   # (ch, P, NB) i32
    d = fit_blocks(px, mask, ch)
    f8_u8 = quantize_factors(*extract_factors(px, d, ch))
    f8 = torch.stack([p.to(torch.int32) for p in f8_u8])
    d = drop_decomposition_axes(d, cfg.num_factors)
    shifts, _ = find_shifts(px, mask, f8, d, cfg)
    if cfg.num_factors < 3:
        forced = torch.tensor([0] * cfg.num_factors + [8] * (3 - cfg.num_factors),
                              dtype=torch.int32, device=packed.device)
        shifts = torch.maximum(shifts, forced[:, None])
    q = dither_crush(f8, shifts, seed, cfg.dither_seed,
                     enabled=cfg.dithering and cfg.crush_bits)
    dec = decode_blocks(q, shifts, d, ch)
    err = (weighted_error(dec, px) * mask.to(torch.int32)).to(torch.float32)
    dist = tree_sum(err, 0)[None]
    q_packed = q[0] + (q[1] << 8) + (q[2] << 16)
    outs = (shifts, q_packed, _pack_decoded(dec, ch), dist)
    if emit_endpoints:
        outs += tuple(getattr(d, f) for f in ENDPOINT_FIELDS) + (d.avg,)
    return outs


@functools.cache
def _library():
    """The built kernel library, with its C signatures declared."""
    from .build import load_library

    lib = load_library("encode_fixed")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.limg_encode_fixed_p64.argtypes = (
        [ptr, ptr] + [i32] * 8 + [ctypes.c_uint32] + [ptr] * 7)
    lib.limg_encode_fixed_p64.restype = i32
    lib.limg_cuda_error_string.argtypes = [i32]
    lib.limg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def encode_blocks_kernel(packed: torch.Tensor, mask: torch.Tensor,
                         cfg: EncodeConfig, seed: int,
                         emit_endpoints: bool = False):
    """Fixed-grid encode of (64, NB) packed blocks; see the module docstring.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel on the current stream or raises.
    """
    global launches
    _check_inputs(packed, mask)
    if packed.device.type == "cpu":
        return encode_blocks_reference(packed, mask, cfg, seed, emit_endpoints)
    if packed.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {packed.device}")
    lib = _library()
    dev = packed.device
    ch, nb = cfg.channels, packed.shape[1]
    # block-major copies: one warp reads one block's 64 contiguous words
    packed_bm = packed.t().contiguous()
    mask_bm = mask.t().contiguous()
    shifts = torch.empty((3, nb), dtype=torch.int32, device=dev)
    q_bm = torch.empty((nb, BLOCK_AREA), dtype=torch.int32, device=dev)
    dec_bm = torch.empty((nb, BLOCK_AREA), dtype=torch.int32, device=dev)
    dist = torch.empty((1, nb), dtype=torch.float32, device=dev)
    eps = avg = None
    if emit_endpoints:
        eps = torch.empty((6, ch, nb), dtype=torch.int32, device=dev)
        avg = torch.empty((ch, nb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.limg_encode_fixed_p64(
            packed_bm.data_ptr(), mask_bm.data_ptr(), nb, ch,
            _CRUSH_MODES.get(cfg.crush_mode, 1) if cfg.crush_bits else 0,
            int(cfg.dithering and cfg.crush_bits), cfg.ladder_k, cfg.num_factors,
            cfg.max_pixel_bit_crush_error, cfg.max_block_bit_crush_error,
            dither_key(seed, cfg.dither_seed),
            shifts.data_ptr(), q_bm.data_ptr(), dec_bm.data_ptr(), dist.data_ptr(),
            None if eps is None else eps.data_ptr(),
            None if avg is None else avg.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"encode_fixed kernel launch failed: "
                           f"{lib.limg_cuda_error_string(rc).decode()} ({rc})")
    launches += 1
    outs = (shifts, q_bm.t(), dec_bm.t(), dist)
    if emit_endpoints:
        outs += tuple(eps.unbind(0)) + (avg,)
    return outs
