"""Encode configuration for limg_tpu_torch.

A copy of ``limg_tpu/config.py``: the JAX package's ``__init__`` imports
JAX, so this port carries its own pure-Python copy, and a test holds every
field and threshold equal to the original.

Every error threshold derives from one ``error_factor`` scalar with fixed
hex multipliers, scaled by the reference's active compile-time flags
(reference: src/limg.cpp:2340-2375, src/limg_internal.h:159-198).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

# Block edge length in pixels (reference: limg_MinBlockSize = 8,
# src/limg_internal.h:157-158).
BLOCK_SIZE = 8
BLOCK_AREA = BLOCK_SIZE * BLOCK_SIZE


# Per-block header bits used by the bits-per-pixel estimate
# (reference: src/limg.cpp:1630 -- channels*(8+1)*2 + channels*8 + 2*16).
def static_block_bits(channels: int) -> int:
    return channels * 9 * 2 + channels * 8 + 2 * 16  # 110 for RGB, 136 for RGBA


CrushMode = Literal["none", "guess", "ladder", "exhaustive"]


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """All knobs of one encode.

    ``crush_mode`` selects how many candidate shift triples are evaluated:

    - "none":       no bit crushing (also when error_factor == 0)
    - "guess":      only the reference's canned guess triples
    - "ladder":     per-axis sweeps rank a 4^3 lattice, then exact
                    verification of the top ``ladder_k`` triples (default)
    - "exhaustive": all 9^3 shift triples, exact
    """

    error_factor: int = 100
    has_alpha: bool = False
    dithering: bool = True
    crush_mode: CrushMode = "ladder"
    ladder_k: int = 8   # exact verifications per block in "ladder" mode
    dither_seed: int = 0xCA7F00D1
    # Number of factor axes used (3 = A,B,C; 2 = A,B; 1 = A only); dropped
    # axes use the shift=8 "factor dropped" encoding.
    num_factors: int = 3

    @property
    def channels(self) -> int:
        return 4 if self.has_alpha else 3

    @property
    def crush_bits(self) -> bool:
        return self.crush_mode != "none" and self.error_factor != 0

    @property
    def max_pixel_block_error(self) -> int:
        return 0x12 * self.error_factor * 4

    @property
    def max_block_pixel_error(self) -> int:
        # compared against blockError * 0x10 / rangeSize
        return 0x1C * (self.error_factor // 3) * 4

    @property
    def max_pixel_channel_block_error(self) -> int:
        return 0x40 * (self.error_factor // 2)

    @property
    def max_block_expand_error(self) -> int:
        return 0x20 * self.error_factor

    @property
    def max_pixel_bit_crush_error(self) -> int:
        return 0x6 * (self.error_factor // 2) * 7

    @property
    def max_block_bit_crush_error(self) -> int:
        # compared against blockError * 0x10 / rangeSize
        return 0x4 * (self.error_factor // 2) * 7


def config_from_jax(cfg) -> EncodeConfig:
    """Any object with EncodeConfig's fields (e.g. limg_tpu's) -> this one."""
    return EncodeConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(EncodeConfig)})
