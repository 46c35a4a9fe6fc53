"""Dithered quantization of factor planes.

Add uniform noise in [-2^(s-1), 2^(s-1)), clamp to u8, then >> s. Shift 0
and the drop encoding (s == 8) get no noise (src/limg.cpp:1951-1958).

The noise comes from a counter-based hash, so that this plain version and
the CUDA kernels (csrc/limg_common.cuh, ``dither_bits_p``) draw the same
bits for the same pixel: 32 bits per (key, region index in its grid, axis,
pixel in the region), built from murmur3's ``fmix32`` finalizer. The
region is an 8x8 block of the image, or a 2^l-block square of the RD
policy's level l, which draws from its own key (``level_key``). The JAX package
draws threefry bits instead, so parity with it is statistical only.
Arithmetic runs in int64 masked to 32 bits, which gives the same bits on
the CPU and the card.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_P = 64          # pixels per 8x8 block
_AXES = 3


def _mul32(h: torch.Tensor | int, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(h):
    """murmur3's 32-bit finalizer on int64 tensors (or ints) in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dither_key(seed: int, dither_seed: int) -> int:
    """The per-encode 32-bit key; the kernel receives it precomputed."""
    return fmix32((int(seed) & _M32) ^ fmix32(int(dither_seed) & _M32))


# folded into the encode's key for the run-coalescing pass, as the JAX
# package folds it into its PRNG key (limg_tpu/regions.py:1433), plus the
# level on the dense path (:956)
COALESCE_SALT = 0x0C0A1E5C


def coalesce_key(seed: int, dither_seed: int, level: int = 0) -> int:
    """The 32-bit dither key of the run-coalescing re-encode: of the fused
    paths' level-0 buffer, or of the dense path's level ``level``."""
    return fmix32(dither_key(seed, dither_seed) ^ (COALESCE_SALT + level))


# folded into the encode's key for the RD policy's per-level encodes at
# levels >= 1, the counterpart of the JAX package's per-level key split
# (limg_tpu/regions.py:1657); SALT + level never equals COALESCE_SALT +
# a level
LEVEL_SALT = 0x1E7E1000


def level_key(seed: int, dither_seed: int, level: int) -> int:
    """The 32-bit dither key of level ``level``'s regions: level 0 (8x8
    blocks) keeps the encode's own key, so that its encode equals the
    fixed grid's; level l >= 1 folds LEVEL_SALT + l into it."""
    key = dither_key(seed, dither_seed)
    return key if level == 0 else fmix32(key ^ (LEVEL_SALT + level))


# folded with an image's index into a corpus encode's seed, the counterpart
# of the JAX package's per-image key split (limg_tpu/parallel/mesh.py:74,
# limg_tpu/parallel/corpus.py:71)
IMAGE_SALT = 0x1A6E5EED


def image_seed(seed: int, index: int) -> int:
    """The 32-bit seed of image ``index`` of a corpus encoded with ``seed``."""
    return fmix32(fmix32((int(seed) & _M32) ^ IMAGE_SALT) ^ (int(index) & _M32))


def dither_bits(key: int, nb: int, device, blocks: torch.Tensor | None = None,
                pixels: int = _P) -> torch.Tensor:
    """(3, pixels, nb) int64 in [0, 2^32): the hash of each (axis, pixel,
    region).

    counter = region * 3P + axis * P + pixel, P = ``pixels`` (region: the
    row-major index of the region in its grid, ``blocks[i]`` for column i,
    default i; for 8x8 blocks block * 192 + axis * 64 + pixel);
    bits = fmix32((fmix32(counter ^ key) + key) mod 2^32).
    """
    blk = (torch.arange(nb, dtype=torch.int64, device=device) if blocks is None
           else blocks.to(device=device, dtype=torch.int64))
    ax = torch.arange(_AXES, dtype=torch.int64, device=device)[:, None, None]
    pix = torch.arange(pixels, dtype=torch.int64, device=device)[None, :, None]
    ctr = (blk[None, None, :] * (_AXES * pixels) + ax * pixels + pix) & _M32
    return fmix32((fmix32(ctr ^ key) + key) & _M32)


def dither_crush(f8: torch.Tensor, shifts: torch.Tensor, seed: int,
                 dither_seed: int, enabled: bool = True,
                 blocks: torch.Tensor | None = None) -> torch.Tensor:
    """Quantize factor planes with optional dithering.

    ``f8``: (3, P, NB) int32 factor planes; ``shifts``: (3, NB) int32;
    ``blocks``: (NB,) region index of each column in its grid (default
    0..NB-1). Returns (3, P, NB) int32 crushed factors (already >> s).
    """
    return dither_crush_key(f8, shifts, dither_key(seed, dither_seed), enabled, blocks)


def dither_crush_key(f8: torch.Tensor, shifts: torch.Tensor, key: int,
                     enabled: bool = True,
                     blocks: torch.Tensor | None = None) -> torch.Tensor:
    """``dither_crush`` with the 32-bit key given directly."""
    s_eff = torch.clamp(shifts, max=8)[:, None, :]            # (3, 1, NB)
    if not enabled:
        return f8 >> s_eff
    bits = dither_bits(key, f8.shape[-1], f8.device, blocks, f8.shape[-2])
    live = (s_eff > 0) & (s_eff < 8)
    mask = (1 << s_eff) - 1
    offset = 1 << torch.clamp(s_eff - 1, min=0)
    noise = torch.where(live, (bits & mask).to(torch.int32) - offset, 0)
    return torch.clamp(f8 + noise, 0, 255) >> s_eff
