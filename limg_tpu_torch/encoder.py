"""Fixed-grid encoder: independent 8x8 blocks, no merging.

Reference entry point: limg_encode3d_test (src/limg.cpp:1887-2265): per block
fit -> factor extraction -> bit-crush search -> dither -> output planes ->
integer decode. Every stage runs on all blocks at once. On a CUDA device
the block encode is one launch of the hand-written kernel
(kernels/encode_fixed.py), and its output planes and decoded image one of
the epilogue kernel (kernels/fixed_planes.py); on the CPU each is the
kernel's plain version.
Asking for a CUDA device where there is none raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import BLOCK_SIZE, EncodeConfig, static_block_bits
from .kernels.encode_fixed import encode_blocks_kernel
from .kernels.fixed_planes import fixed_planes_kernel
from .ops import layout
from .ops.error import psnr as weighted_psnr
from .ops.fit import ENDPOINT_FIELDS, Decomposition
from .utils.diagnostics import span


class EncodeResult(NamedTuple):
    """Device-side encode outputs (block layout)."""

    decomposition: Decomposition   # endpoints: (ch, NB) int32
    factors: torch.Tensor          # (3, P, NB) int32, crushed (already >> s)
    shifts: torch.Tensor           # (3, NB) int32
    decoded: torch.Tensor          # (ch, P, NB) int32
    mask: torch.Tensor             # (P, NB) bool
    accum_bits: torch.Tensor       # (3,) int64 -- total factor bits per axis
    bits_histogram: torch.Tensor   # (3, 9) int64 -- pixels at shift s per axis
    bpp_block: torch.Tensor        # (NB,) int32 -- rounded u8 bpp estimate


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; raises if it is CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' for the plain version")
    return dev


def _as_image_tensor(image, device: torch.device) -> torch.Tensor:
    if isinstance(image, np.ndarray):
        image = np.ascontiguousarray(image)
        image = torch.from_numpy(image if image.flags.writeable else image.copy())
    if image.dtype != torch.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {tuple(image.shape)} {image.dtype}")
    return image.to(device)


def _packed_blocks(image: torch.Tensor):
    """(H, W, 3|4) uint8 -> (64, NB) int32 packed words, mask, grid.

    RGB gets a zero alpha byte, which gives the words of
    ``pack_channels(blockify(image)[0])`` without int64 arithmetic.
    """
    if image.shape[2] == 3:
        image = torch.nn.functional.pad(image, (0, 1))
    return layout.blockify_packed(image, BLOCK_SIZE)


def _block_stats(shifts: torch.Tensor, mask: torch.Tensor, channels: int):
    count = mask.to(torch.int64).sum(dim=0)                          # (NB,)
    s_eff = torch.clamp(shifts, max=8).to(torch.int64)               # (3, NB)
    bits_each = (8 - s_eff) * count[None]
    accum_bits = bits_each.sum(dim=1)
    one_hot = s_eff[:, None, :] == torch.arange(9, device=shifts.device)[None, :, None]
    bits_histogram = (one_hot * count[None, None, :]).sum(dim=2)
    # rounded per-pixel bits estimate (src/limg.cpp:1629-1636)
    block_bits = static_block_bits(channels) + bits_each.sum(dim=0)
    bpp_block = torch.clamp((block_bits + count // 2) // count, max=0xFF).to(torch.int32)
    return accum_bits, bits_histogram, bpp_block


def _encode_blocks(packed: torch.Tensor, mask: torch.Tensor, cfg: EncodeConfig, seed: int,
                   grid: layout.BlockGrid | None = None):
    """``encode_blocks``, and the decoded (H, W, 4) uint8 image of ``grid``
    (None without one): (EncodeResult, image)."""
    ch = cfg.channels
    outs = encode_blocks_kernel(packed, mask, cfg, seed, emit_endpoints=True)
    shifts, q_packed, dec_packed = outs[:3]
    # the words' block-major (NB, 64) storage behind the kernel's (64, NB) views
    factors, decoded, image = fixed_planes_kernel(q_packed.t(), dec_packed.t(), ch, grid)
    d = Decomposition(avg=outs[10], **dict(zip(ENDPOINT_FIELDS, outs[4:10])))
    accum_bits, bits_histogram, bpp_block = _block_stats(shifts, mask, ch)
    res = EncodeResult(
        decomposition=d,
        factors=factors,
        shifts=shifts,
        decoded=decoded,
        mask=mask,
        accum_bits=accum_bits,
        bits_histogram=bits_histogram,
        bpp_block=bpp_block,
    )
    return res, image


def encode_blocks(packed: torch.Tensor, mask: torch.Tensor, cfg: EncodeConfig,
                  seed: int = 0) -> EncodeResult:
    """Encode pre-blockified (64, NB) packed words + (64, NB) mask.

    Runs on the device of ``packed``: the kernels on CUDA (the block encode,
    then the epilogue that unpacks its words into the planes), the plain
    versions on the CPU.
    """
    return _encode_blocks(packed, mask, cfg, seed)[0]


def encode_image_device(image, cfg: EncodeConfig, seed: int = 0, device="cuda"):
    """(H, W, 3|4) uint8 -> (decoded (H, W, 4) uint8 tensor, EncodeResult, grid),
    all on ``device``."""
    with span("limg.encode_image_device"):
        dev = resolve_device(device)
        img = _as_image_tensor(image, dev)
        with span("limg.fixed.blockify"):
            packed, mask, grid = _packed_blocks(img)
        with span("limg.fixed.encode"):
            # the epilogue writes the decoded image with the planes
            res, decoded = _encode_blocks(packed, mask, cfg, seed, grid)
        with span("limg.fixed.assemble"):
            pass  # the stage the breakdown names; its work is in the epilogue
        return decoded, res, grid


def encode_perf_step(image, cfg: EncodeConfig, seed: int = 0, device="cuda"):
    """Throughput step: the full block encode from the device-resident image,
    returning only two checksums (reference: limg_encode3d_test_perf,
    src/limg.cpp:2140-2327)."""
    dev = resolve_device(device)
    packed, mask, _ = _packed_blocks(_as_image_tensor(image, dev))
    shifts, _, dec_packed = encode_blocks_kernel(packed, mask, cfg, seed)[:3]
    return dec_packed.sum(), shifts.sum()


def encode_image(image, cfg: EncodeConfig, seed: int = 0, device="cuda"):
    """Host-facing full encode. Returns a dict of NumPy planes + stats, with
    the keys of ``limg_tpu.encode_image``."""
    dev = resolve_device(device)
    img = _as_image_tensor(image, dev)
    decoded, res, grid = encode_image_device(img, cfg, seed, dev)

    f_shifted = (res.factors << torch.clamp(res.shifts, max=8)[:, None, :]) & 0xFF
    planes = layout.unblockify(f_shifted.to(torch.uint8), grid)     # (H, W, 3)
    shift_plane = layout.broadcast_block_plane(res.shifts, grid)    # (3, H, W)
    bpp_plane = layout.broadcast_block_plane(res.bpp_block, grid)   # (H, W)
    psnr, mse = weighted_psnr(img, decoded, cfg.channels)

    # endpoint-color visualization planes (+0x80 bias on the B/C offsets,
    # src/limg.cpp:1609-1617)
    d = res.decomposition

    def color_plane(vals, bias=0):
        v = torch.clamp(vals + bias, 0, 255).to(torch.uint8)        # (ch, NB)
        img_p = layout.broadcast_block_plane(v, grid)               # (ch, H, W)
        rgba = torch.full((4, *img_p.shape[1:]), 0xFF, dtype=torch.uint8, device=dev)
        rgba[: v.shape[0]] = img_p
        return rgba.permute(1, 2, 0).cpu().numpy()

    def host(t):
        return t.cpu().numpy()

    bpp_np = host(bpp_plane)
    total_px = img.shape[0] * img.shape[1]
    return dict(
        decoded=host(decoded),
        factors_a=host(planes[..., 0]),
        factors_b=host(planes[..., 1]),
        factors_c=host(planes[..., 2]),
        shift=host(shift_plane).transpose(1, 2, 0).astype(np.uint8),
        bpp=bpp_np.astype(np.uint8),
        endpoints={
            "colAMin": host(d.dirA_min),
            "colAMax": host(d.dirA_max),
            "colBMin": host(d.dirB_offset),
            "colBMax": host(d.dirB_mag),
            "colCMin": host(d.dirC_offset),
            "colCMax": host(d.dirC_mag),
        },
        endpoint_planes={
            "col_a_min": color_plane(d.dirA_min),
            "col_a_max": color_plane(d.dirA_max),
            "col_b_min": color_plane(d.dirB_offset, 0x80),
            "col_b_max": color_plane(d.dirB_mag, 0x80),
            "col_c_min": color_plane(d.dirC_offset, 0x80),
            "col_c_max": color_plane(d.dirC_mag, 0x80),
        },
        psnr=float(psnr),
        mse=float(mse),
        mean_bpp=float(bpp_np.mean()),
        avg_block_bits=float(int(res.accum_bits.sum()) / total_px),
        bits_histogram=host(res.bits_histogram),
    )
