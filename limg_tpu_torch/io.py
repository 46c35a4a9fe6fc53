"""Image I/O: loading via PIL, debug dumps as TGA.

A copy of ``limg_tpu/io.py`` (which cannot be imported without JAX).
PIL is imported inside ``load_image`` only, so the module imports on a
machine without it. ``write_tga`` is an 18-byte header plus raw BGRA.
"""

from __future__ import annotations

import struct

import numpy as np


def load_image(path: str):
    """Load any PIL-supported image -> ((H, W, 4) uint8 RGBA, has_alpha)."""
    from PIL import Image

    with Image.open(path) as im:
        has_alpha = im.mode in ("RGBA", "LA", "PA") or "transparency" in im.info
        rgba = np.asarray(im.convert("RGBA"))
    return rgba, has_alpha


def write_tga(path: str, data: np.ndarray) -> None:
    """Write (H, W) grayscale or (H, W, 4) RGBA uint8 as an uncompressed TGA."""
    data = np.ascontiguousarray(data)
    h, w = data.shape[:2]
    if data.ndim == 2:
        header = struct.pack("<BBBHHBHHHHBB", 0, 0, 3, 0, 0, 0, 0, 0, w, h, 8, 0x20)
        payload = data
    else:
        assert data.shape[2] == 4
        header = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 32, 0x28)
        payload = data[..., [2, 1, 0, 3]]  # RGBA -> BGRA
    with open(path, "wb") as f:
        f.write(header)
        f.write(payload.tobytes())
