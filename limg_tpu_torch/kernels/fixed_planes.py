"""The fixed grid's output epilogue: the CUDA kernel's wrapper and its plain
version.

``fixed_planes_kernel`` turns the block encode's packed words, block-major
as ``encode_blocks_kernel`` writes them at P = 64 (q and dec, (NB, 64)
int32), into the fixed-grid outputs, in their layouts:

    factors (3, 64, NB) int32 (q's bytes), decoded (ch, 64, NB) int32
    (dec's bytes) [, the decoded (H, W, 4) uint8 image of ``grid``]

It replaces no Pallas kernel: the JAX package's fixed-grid encode returns
its planes unpacked from the Pallas kernel's words in jnp. The plain
version, ``fixed_planes_reference``, is the composition of PyTorch
operations: ``unpack_plane`` and ``torch.stack`` for the planes, and
``assemble_decoded`` (a cast, ``layout.unblockify`` and an alpha plane of
0xFF for RGB) for the image. On a CUDA tensor the wrapper launches
``csrc/fixed_planes.cu`` (built at first use), one pass over the words, or
raises; on a CPU tensor it runs the plain version. The two agree bit for
bit: the kernel sets the alpha byte of RGB words to 0xFF.
"""

from __future__ import annotations

import torch

from ..config import BLOCK_AREA, BLOCK_SIZE
from ..ops import layout
from . import launch


def _check(q_bm: torch.Tensor, dec_bm: torch.Tensor, channels: int, grid) -> None:
    for name, t in (("q_bm", q_bm), ("dec_bm", dec_bm)):
        if t.ndim != 2 or t.shape[1] != BLOCK_AREA or t.dtype != torch.int32:
            raise ValueError(f"{name} must be (NB, {BLOCK_AREA}) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dec_bm.shape != q_bm.shape or dec_bm.device != q_bm.device:
        raise ValueError(f"q_bm {tuple(q_bm.shape)} on {q_bm.device} but dec_bm "
                         f"{tuple(dec_bm.shape)} on {dec_bm.device}")
    if channels not in (3, 4):
        raise ValueError(f"channels must be 3 or 4, got {channels}")
    if grid is not None and grid.num_blocks != q_bm.shape[0]:
        raise ValueError(f"grid of {grid.num_blocks} blocks for {q_bm.shape[0]} blocks of words")


def assemble_decoded(decoded_blocks: torch.Tensor, grid: layout.BlockGrid,
                     channels: int) -> torch.Tensor:
    """Block-layout decode -> (H, W, 4) uint8 RGBA (alpha = 0xFF for RGB)."""
    dec = layout.unblockify(decoded_blocks.to(torch.uint8), grid, BLOCK_SIZE)
    if channels == 3:
        alpha = torch.full((*dec.shape[:2], 1), 0xFF, dtype=torch.uint8, device=dec.device)
        dec = torch.cat([dec, alpha], dim=-1)
    return dec


def fixed_planes_reference(q_bm: torch.Tensor, dec_bm: torch.Tensor, channels: int,
                           grid: layout.BlockGrid | None = None):
    """Plain version of fixed_planes_kernel, on any device and any strides."""
    _check(q_bm, dec_bm, channels, grid)
    factors = torch.stack([layout.unpack_plane(q_bm.t(), c) for c in range(3)])
    decoded = torch.stack([layout.unpack_plane(dec_bm.t(), c) for c in range(channels)])
    image = None if grid is None else assemble_decoded(decoded, grid, channels)
    return factors, decoded, image


def fixed_planes_kernel(q_bm: torch.Tensor, dec_bm: torch.Tensor, channels: int,
                        grid: layout.BlockGrid | None = None):
    """(factors, decoded, image) from the block-major words; see the module
    docstring. ``image`` is None without ``grid``. A CPU tensor goes to the
    plain version; a CUDA tensor (contiguous, 16-byte aligned) launches the
    kernel on the current stream or raises."""
    _check(q_bm, dec_bm, channels, grid)
    dev = q_bm.device
    if not launch.on_card(dev):
        return fixed_planes_reference(q_bm, dec_bm, channels, grid)
    if not (q_bm.is_contiguous() and dec_bm.is_contiguous()):
        raise ValueError("q_bm and dec_bm must be contiguous on the card")
    if q_bm.data_ptr() % 16 or dec_bm.data_ptr() % 16:
        # the kernel reads them as int4
        raise ValueError("q_bm and dec_bm must be 16-byte aligned on the card")
    nb = q_bm.shape[0]
    factors = torch.empty((3, BLOCK_AREA, nb), dtype=torch.int32, device=dev)
    decoded = torch.empty((channels, BLOCK_AREA, nb), dtype=torch.int32, device=dev)
    image = out = None
    blocks_x, out_h, out_w = 1, 0, 0
    if grid is not None:
        blocks_x = grid.blocks_x
        if channels == 3:
            out_h, out_w = grid.height, grid.width
            image = out = torch.empty((out_h, out_w, 4), dtype=torch.uint8, device=dev)
        else:
            # the plain assembly's layout: the padded grid's image, cropped as a view
            out_h, out_w = grid.blocks_y * BLOCK_SIZE, grid.blocks_x * BLOCK_SIZE
            out = torch.empty((out_h, out_w, 4), dtype=torch.uint8, device=dev)
            image = out[: grid.height, : grid.width]
    launch.call(launch.library("fixed_planes"), "limg_fixed_planes", "fixed_planes",
                dev, q_bm.data_ptr(), dec_bm.data_ptr(), nb, channels, blocks_x, out_h, out_w,
                factors.data_ptr(), decoded.data_ptr(), None if out is None else out.data_ptr())
    return factors, decoded, image
