"""Streaming corpus encode: native host staging overlapped with the encode.

The counterpart of ``limg_tpu/parallel/corpus.py``. The native
``StagingPool`` (``limg_tpu_torch/native.py``) decodes and blockifies
files on host threads while the device encodes earlier images; the device
takes each image's packed (64, NB) words directly, through the fixed-grid
kernel. The loop waits on each file's own status cell, so the first encode
starts as soon as the first file is staged (the JAX loop's wait,
limg_tpu/parallel/corpus.py:79-81, spins until the whole pool is idle), and
it keeps at most ``2 * threads`` files staged ahead of the one it encodes,
so the slots it holds stay bounded whatever the corpus's length.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from .. import native
from ..config import EncodeConfig
from ..encoder import resolve_device
from ..kernels.encode_fixed import encode_blocks_kernel
from ..ops.dither import image_seed
from .mesh import _factor_bits, _image_stats, _read_image

_POLL_S = 1e-4      # between two reads of a slot's status cell


def _encode_packed_stats(packed: torch.Tensor, mask: torch.Tensor, cfg: EncodeConfig,
                         seed: int):
    """(64, NB) int32 packed words and (64, NB) bool mask of an image, on
    one device -> its (psnr, bpp) as 0-d float32 tensors there
    (limg_tpu/parallel/corpus.py:31; its pixels counted from the mask)."""
    shifts, _, _, dist = encode_blocks_kernel(packed, mask, cfg, seed)[:4]
    bits = _factor_bits(shifts, mask).sum()
    return _image_stats(dist.to(torch.float64).sum(), bits, mask.sum(), packed.shape[1],
                        cfg.channels)


def _upload(packed: np.ndarray, mask: np.ndarray, dev: torch.device):
    """A slot's (64, NB) uint32 words and uint8 0/1 mask -> int32 and bool
    tensors on ``dev`` (shared with the slot on the CPU)."""
    return (torch.from_numpy(packed.view(np.int32)).to(dev, non_blocking=True),
            torch.from_numpy(mask.view(np.bool_)).to(dev, non_blocking=True))


def _await_slot(status: np.ndarray) -> None:
    """Wait until a worker has finished this slot, whose status cell then
    leaves 0, however many other files are still being staged."""
    while status[0] == 0:
        time.sleep(_POLL_S)


def _staged(pool: native.StagingPool, paths, height: int, width: int):
    """Each path's (packed, mask, status) slot in order, with up to
    ``2 * pool.threads`` more files queued behind the one handed out."""
    ahead = deque()
    for path in paths:
        ahead.append(pool.stage(os.fspath(path), height, width))
        if len(ahead) > 2 * pool.threads:
            yield ahead.popleft()
    while ahead:
        yield ahead.popleft()


def encode_corpus_streaming(paths, height: int, width: int, cfg: EncodeConfig,
                            pool_threads: int | None = None, seed: int = 0,
                            device="cuda") -> dict:
    """Encode same-size TGA / PPM files with host staging overlapping the
    device encode (limg_tpu/parallel/corpus.py:60). Image i draws its
    dither from ``image_seed(seed, i)``.

    Returns ``psnr`` and ``bpp`` (N,) and ``failed``, the indices of files
    the pool could not read or whose size is not (height, width) (their
    stats stay 0). Without the native runtime the files are read one by one
    (TGA without PIL).
    """
    dev = resolve_device(device)
    stats, failed = [], []
    if native.available():
        pool = native.StagingPool(pool_threads)
        try:
            for i, (packed, mask, status) in enumerate(_staged(pool, paths, height, width)):
                _await_slot(status)
                if status[0] != 1:
                    failed.append(i)
                    continue
                stats.append((i, _encode_packed_stats(*_upload(packed, mask, dev), cfg,
                                                      image_seed(seed, i))))
        finally:
            pool.close()
    else:
        for i, path in enumerate(paths):
            img = _read_image(path)
            if img.shape[:2] != (height, width):    # as the pool reports it
                failed.append(i)
                continue
            packed, mask = native.blockify_packed(img)
            stats.append((i, _encode_packed_stats(*_upload(packed, mask, dev), cfg,
                                                  image_seed(seed, i))))
    psnr = np.zeros(len(paths), np.float64)
    bpp = np.zeros(len(paths), np.float64)
    if stats:   # one fetch for the whole corpus
        got = torch.stack([torch.stack(s) for _, s in stats]).cpu().numpy()
        idx = [i for i, _ in stats]
        psnr[idx], bpp[idx] = got[:, 0], got[:, 1]
    return {"psnr": psnr, "bpp": bpp, "failed": failed}
