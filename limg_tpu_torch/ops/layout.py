"""Image <-> block-tensor layout transforms.

The encoder works on the JAX package's canonical layout ``(ch, P, NB)``:
channels outermost, the P = 64 pixels of an 8x8 block in row-major order,
and the blocks of the image, row-major over the block grid, along the last
axis. Masks are ``(P, NB)``; per-block values are ``(..., NB)``. Every
function returns tensors on the device of its input.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import BLOCK_SIZE


class BlockGrid(NamedTuple):
    height: int
    width: int
    blocks_y: int
    blocks_x: int

    @property
    def num_blocks(self) -> int:
        return self.blocks_y * self.blocks_x


def grid_for(height: int, width: int, block: int = BLOCK_SIZE) -> BlockGrid:
    return BlockGrid(height, width, -(-height // block), -(-width // block))


def _block_mask(h: int, w: int, g: BlockGrid, block: int, device) -> torch.Tensor:
    """(block*block, NB) bool validity mask, built on ``device``."""
    ys = torch.arange(g.blocks_y * block, device=device).reshape(g.blocks_y, block)
    xs = torch.arange(g.blocks_x * block, device=device).reshape(g.blocks_x, block)
    valid = (ys < h)[:, :, None, None] & (xs < w)[None, None, :, :]  # (By,b,Bx,b)
    return valid.permute(1, 3, 0, 2).reshape(block * block, g.num_blocks)


def _pad_to_grid(image: torch.Tensor, g: BlockGrid, block: int) -> torch.Tensor:
    h, w = image.shape[:2]
    hp, wp = g.blocks_y * block, g.blocks_x * block
    if (hp, wp) == (h, w):
        return image
    padded = image.new_zeros((hp, wp, *image.shape[2:]))
    padded[:h, :w] = image
    return padded


def blockify(image: torch.Tensor, block: int = BLOCK_SIZE):
    """(H, W, C) uint8 -> (C, block*block, NB) uint8 + (block*block, NB) mask.

    Edge blocks are zero-padded; ``mask`` marks real pixels. Pixel order
    within a block is row-major.
    """
    h, w, c = image.shape
    g = grid_for(h, w, block)
    tiles = _pad_to_grid(image, g, block).reshape(
        g.blocks_y, block, g.blocks_x, block, c)
    # (By, b, Bx, b, C) -> (C, b, b, By, Bx) -> (C, P, NB)
    px = tiles.permute(4, 1, 3, 0, 2).reshape(c, block * block, g.num_blocks)
    return px, _block_mask(h, w, g, block, image.device), g


def packed_words(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 RGBA -> (H, W) int32 words, R in the low byte.

    A reinterpretation of the bytes (little-endian), with no copy when the
    image is contiguous.
    """
    return image.contiguous().view(torch.int32)[..., 0]


def blockify_packed(image: torch.Tensor, block: int = BLOCK_SIZE):
    """(H, W, 4) uint8 RGBA -> ((block*block, NB) int32 packed words, mask,
    grid). Bit-identical to ``pack_channels(blockify(image)[0])``."""
    h, w, c = image.shape
    if c != 4:
        raise ValueError("blockify_packed requires an RGBA image")
    g = grid_for(h, w, block)
    tiles = _pad_to_grid(packed_words(image), g, block).reshape(
        g.blocks_y, block, g.blocks_x, block)
    px = tiles.permute(1, 3, 0, 2).reshape(block * block, g.num_blocks)
    return px, _block_mask(h, w, g, block, image.device), g


def unblockify(px: torch.Tensor, grid: BlockGrid, block: int = BLOCK_SIZE) -> torch.Tensor:
    """(C, block*block, NB) -> (H, W, C), cropping edge padding."""
    c = px.shape[0]
    tiles = px.reshape(c, block, block, grid.blocks_y, grid.blocks_x)
    img = tiles.permute(3, 1, 4, 2, 0).reshape(
        grid.blocks_y * block, grid.blocks_x * block, c)
    return img[: grid.height, : grid.width]


def broadcast_block_plane(vals: torch.Tensor, grid: BlockGrid,
                          block: int = BLOCK_SIZE) -> torch.Tensor:
    """Per-block values (..., NB) -> per-pixel plane (..., H, W)."""
    lead = vals.shape[:-1]
    v = vals.reshape(*lead, grid.blocks_y, 1, grid.blocks_x, 1)
    v = v.expand(*lead, grid.blocks_y, block, grid.blocks_x, block)
    img = v.reshape(*lead, grid.blocks_y * block, grid.blocks_x * block)
    return img[..., : grid.height, : grid.width]


def pack_channels(px_u8: torch.Tensor) -> torch.Tensor:
    """(C, P, NB) uint8 -> (P, NB) int32 packed (c0 | c1<<8 | c2<<16 ...).

    A 4th channel >= 128 sets the sign bit: the word is the same 32 bits
    as the byte quadruple.
    """
    c = px_u8.shape[0]
    packed = px_u8[0].to(torch.int64)
    for i in range(1, min(c, 4)):
        packed = packed + (px_u8[i].to(torch.int64) << (8 * i))
    return to_int32_bits(packed)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def unpack_plane(packed: torch.Tensor, idx: int) -> torch.Tensor:
    return (packed >> (8 * idx)) & 0xFF
