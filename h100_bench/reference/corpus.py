"""The fixed-grid corpus encode over several devices, in plain PyTorch.

The plain reference of the port's ``parallel.mesh.encode_corpus_sharded``,
written from this package's own modules: a batch of N same-size frames is
split into ``n_devices`` shards of N / n_devices frames; shard k holds
frames ``[k*n, (k+1)*n)``, runs on its own device, and is one encode over
its frames' 8x8 blocks joined on the block axis (the plain version of the
fixed grid's kernel), dithered from ``image_seed(seed, k*n)``. Each frame's
weighted error is the sum of its blocks' float32 errors in float64, its
factor bits an int64 sum; PSNR and bits per pixel are float32, a total over
a Python-int pixel count computed as a product with its reciprocal. The
corpus-mean PSNR adds each shard's float64 sum on the first device, in
shard order, and divides by N.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EncodeConfig, static_block_bits
from .encoder import _packed_blocks
from .kernels.encode_fixed import encode_blocks_kernel
from .ops.dither import image_seed
from .ops.error import max_possible_error


def _per_pixel(total: torch.Tensor, npx: int) -> torch.Tensor:
    """``total / npx`` as a product with the reciprocal, in ``total``'s dtype."""
    recip = (torch.ones((), dtype=total.dtype) / npx).item()
    return total * torch.full((), recip, dtype=total.dtype, device=total.device)


def _frame_stats(err: torch.Tensor, bits: torch.Tensor, npx: int, nb: int, channels: int):
    """(psnr, bpp) float32 of frames from their float64 errors and int64 bits."""
    mse = _per_pixel(err, npx)
    psnr = 10.0 * torch.log10(max_possible_error(channels) / torch.clamp(mse, min=1e-12))
    total = (bits + static_block_bits(channels) * nb).to(torch.float32)
    return psnr.to(torch.float32), _per_pixel(total, npx)


def _shard(frames: torch.Tensor, cfg: EncodeConfig, seed: int):
    """One shard's (n, H, W, C) frames, on their device -> per-frame (psnr, bpp)."""
    n, h, w = frames.shape[:3]
    blocks = [_packed_blocks(f) for f in frames]
    nb = blocks[0][2].num_blocks
    packed = torch.cat([b[0] for b in blocks], dim=1)
    mask = torch.cat([b[1] for b in blocks], dim=1)
    shifts, _, _, dist = encode_blocks_kernel(packed, mask, cfg, seed)[:4]
    err = dist[0].to(torch.float64).reshape(n, nb).sum(dim=1)
    bits = ((8 - torch.clamp(shifts, max=8)) * mask.sum(dim=0)).reshape(3, n, nb).sum(dim=(0, 2))
    return _frame_stats(err, bits, h * w, nb, cfg.channels)


def encode_corpus_sharded(images, cfg: EncodeConfig, n_devices: int, seed: int,
                          devices) -> dict:
    """``images`` (N, H, W, 3|4) uint8 (NumPy or tensor), N divisible by
    ``n_devices``; ``devices`` the device of each shard. Returns per-frame
    ``psnr`` and ``bpp`` (float32 NumPy) and ``mean_psnr`` (a float)."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.ascontiguousarray(images))
    devs = [torch.device(d) for d in devices]
    n = images.shape[0]
    if len(devs) != n_devices or n % n_devices:
        raise ValueError(f"{n} frames on {n_devices} shards, {len(devs)} devices")
    n_loc = n // n_devices
    parts = [_shard(images[k * n_loc:(k + 1) * n_loc].to(dev), cfg, image_seed(seed, k * n_loc))
             for k, dev in enumerate(devs)]
    first = devs[0]
    total = parts[0][0].to(torch.float64).sum().to(first)
    for psnr, _ in parts[1:]:
        total = total + psnr.to(torch.float64).sum().to(first)
    mean = total / torch.full((), n, dtype=torch.float64, device=first)
    return {"psnr": torch.cat([p.to(first) for p, _ in parts]).cpu().numpy(),
            "bpp": torch.cat([b.to(first) for _, b in parts]).cpu().numpy(),
            "mean_psnr": float(mean)}
