"""Region encode: the CUDA kernels' wrapper and their plain version.

``encode_blocks_kernel`` takes the arguments of the JAX package's
``encode_blocks_pallas`` (limg_tpu/pallas_kernels/encode_fixed.py:808) at
every P = 64 * 4^l: 8x8 blocks (P = 64: the fixed grid, level 0 of the RD
and dense paths) and the 2^l x 2^l-block regions of the quadtree levels
l >= 1 (16x16, 32x32, 64x64 pixels, and from level 4 on 128x128 pixels and
larger: the dense path's levels 4 and up, which the JAX package encodes in
jnp, limg_tpu/regions.py:191, since its Pallas kernel has no geometry above
P = 4096, encode_fixed.py:76-77), and returns its outputs in its layouts:

    shifts (3, NB) i32, q_packed (P, NB) i32, dec_packed (P, NB) i32,
    dist (1, NB) f32 [, dirA_min, dirA_max, dirB_offset, dirB_mag,
    dirC_offset, dirC_mag (ch, NB) i32, avg (ch, NB) f32]

On a CUDA tensor it launches ``csrc/encode_fixed.cu`` (P = 64) or
``csrc/encode_region.cu`` (P > 64), each built at first use from one
template, ``csrc/region_encode.cuh`` (a region's pixels 8 a thread over
P / 8 threads up to P = 4096; a larger region a thread-block cluster of
up to 16 CTAs, each a subtree of the region's halving tree walked as
chunks of 4096 from shared memory; the owner crush's crush search), and
raises if
the launch fails; on a CPU tensor it runs ``encode_blocks_reference``,
which composes the plain ops of ``limg_tpu_torch.ops`` in the kernels'
arithmetic order: every float sum over a region's P pixels is one halving
tree. The two agree bit for bit on the card. The JAX kernel sums 256-pixel
chunks and then folds the chunks, so a rounded endpoint can differ from
it by 1 at P >= 1024.

The dither key of a region of P = 64 * 4^l pixels is ``level_key(seed,
cfg.dither_seed, l)``: at P = 64 the fixed grid's own key.
"""

from __future__ import annotations

import torch

from ..config import BLOCK_AREA, EncodeConfig
from ..ops.crush import find_shifts, force_dropped_axes
from ..ops.decode import decode_blocks
from ..ops.dither import dither_crush_key, level_key
from ..ops.error import weighted_error
from ..ops.factors import extract_factors, quantize_factors
from ..ops.fit import (ENDPOINT_FIELDS, drop_decomposition_axes, fit_blocks,
                       tree_sum)
from ..ops.layout import unpack_plane
from . import launch

# the largest region the kernels take: a 32768 x 32768 pixel square (level
# 12), whose words fill 4 GiB; pixel indices stay within int32
MAX_REGION_PIXELS = BLOCK_AREA << 24

# the C entries: the 8x8-block kernel (csrc/encode_fixed.cu) and the region
# kernel of every P > 64 (csrc/encode_region.cu, which also takes P)

def region_level(pixels: int) -> int:
    """The quadtree level l of a region of pixels = 64 * 4^l; raises
    ValueError for another count, or one above MAX_REGION_PIXELS."""
    lvl = max(0, (int(pixels).bit_length() - BLOCK_AREA.bit_length()) // 2)
    if BLOCK_AREA << 2 * lvl != pixels or pixels > MAX_REGION_PIXELS:
        raise ValueError(f"P must be 64 * 4^l, at most {MAX_REGION_PIXELS}, got P = {pixels}")
    return lvl


def _check_inputs(packed: torch.Tensor, mask: torch.Tensor) -> None:
    if packed.ndim != 2 or packed.dtype != torch.int32:
        raise ValueError(f"packed must be (P, NB) int32, got {tuple(packed.shape)} {packed.dtype}")
    region_level(packed.shape[0])
    if mask.shape != packed.shape or mask.dtype != torch.bool:
        raise ValueError(f"mask must be {tuple(packed.shape)} bool, got {tuple(mask.shape)} {mask.dtype}")
    if mask.device != packed.device:
        raise ValueError(f"packed on {packed.device} but mask on {mask.device}")


def encode_blocks_reference(packed: torch.Tensor, mask: torch.Tensor,
                            cfg: EncodeConfig, seed: int,
                            emit_endpoints: bool = False):
    """Plain PyTorch version of the kernels, on any device."""
    _check_inputs(packed, mask)
    ch = cfg.channels
    px = torch.stack([unpack_plane(packed, c) for c in range(ch)])   # (ch, P, NB) i32
    d = fit_blocks(px, mask, ch)
    f8_u8 = quantize_factors(*extract_factors(px, d, ch))
    f8 = torch.stack([p.to(torch.int32) for p in f8_u8])
    d = drop_decomposition_axes(d, cfg.num_factors)
    shifts = force_dropped_axes(find_shifts(px, mask, f8, d, cfg)[0], cfg.num_factors)
    q = dither_crush_key(f8, shifts, level_key(seed, cfg.dither_seed, region_level(packed.shape[0])),
                         enabled=cfg.dithering and cfg.crush_bits)
    dec = decode_blocks(q, shifts, d, ch)
    err = (weighted_error(dec, px) * mask.to(torch.int32)).to(torch.float32)
    dist = tree_sum(err, 0)[None]
    q_packed = q[0] + (q[1] << 8) + (q[2] << 16)
    outs = (shifts, q_packed, launch.pack_decoded(dec, ch), dist)
    if emit_endpoints:
        outs += tuple(getattr(d, f) for f in ENDPOINT_FIELDS) + (d.avg,)
    return outs


def encode_blocks_kernel(packed: torch.Tensor, mask: torch.Tensor,
                         cfg: EncodeConfig, seed: int,
                         emit_endpoints: bool = False):
    """Encode of (P, NB) packed regions; see the module docstring.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel of its P on the current stream or raises.
    """
    _check_inputs(packed, mask)
    if not launch.on_card(packed.device):
        return encode_blocks_reference(packed, mask, cfg, seed, emit_endpoints)
    dev = packed.device
    ch, (p, nb) = cfg.channels, packed.shape
    # block-major copies: a region's threads read its contiguous words
    packed_bm = packed.t().contiguous()
    mask_bm = mask.t().contiguous()
    shifts = torch.empty((3, nb), dtype=torch.int32, device=dev)
    q_bm = torch.empty((nb, p), dtype=torch.int32, device=dev)
    dec_bm = torch.empty((nb, p), dtype=torch.int32, device=dev)
    dist = torch.empty((1, nb), dtype=torch.float32, device=dev)
    eps = avg = None
    if emit_endpoints:
        eps = torch.empty((6, ch, nb), dtype=torch.int32, device=dev)
        avg = torch.empty((ch, nb), dtype=torch.float32, device=dev)
    settings = (ch, *launch.crush_args(cfg, level_key(seed, cfg.dither_seed, region_level(p))))
    outs_ptr = (shifts.data_ptr(), q_bm.data_ptr(), dec_bm.data_ptr(), dist.data_ptr(),
                None if eps is None else eps.data_ptr(),
                None if avg is None else avg.data_ptr())
    if p == BLOCK_AREA:
        lib = launch.library("encode_fixed")
        launch.call(lib, "limg_encode_fixed_p64", "encode_fixed_p64", dev,
                    packed_bm.data_ptr(), mask_bm.data_ptr(), nb, *settings, *outs_ptr)
    else:
        lib = launch.library("encode_region")
        launch.call(lib, "limg_encode_region", f"encode_region_p{p}", dev,
                    packed_bm.data_ptr(), mask_bm.data_ptr(), nb, p, *settings, *outs_ptr)
    outs = (shifts, q_bm.t(), dec_bm.t(), dist)
    if emit_endpoints:
        outs += tuple(eps.unbind(0)) + (avg,)
    return outs
