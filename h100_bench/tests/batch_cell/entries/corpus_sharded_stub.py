"""``parallel.mesh.encode_corpus_sharded`` over the cell's cards: the entry of
the batch cell that the harness's own tests add (``tests/batch_cell/``).

The program encodes each call's (B, H, W, 3) batch split over the cards
(on two cards it receives the tuple of the cell's cards). The reference, which
has no corpus entry point, encodes the frames one by one on the first card
with ``encode_image_device``; with dithering off both give each frame's
bits exactly, and ``bpp_gap`` compares the per-frame bits per pixel (in
float32, as the corpus computes them).
"""

from __future__ import annotations

import importlib

import numpy as np

from ..harness.entry import Output


def _mesh(lib):
    """The program's ``parallel.mesh``; None for the reference."""
    try:
        return importlib.import_module(f"{lib.__name__}.parallel.mesh")
    except ImportError:
        return None


def call(lib, batch, cfg, seed: int, params: dict, devices: tuple) -> Output:
    mesh = _mesh(lib)
    if mesh is not None:
        out = mesh.encode_corpus_sharded(batch, cfg, n_devices=len(devices), seed=seed,
                                         device=devices[0].type)
        return Output({"bpp": np.asarray(out["bpp"], np.float64)}, None)
    static = importlib.import_module(f"{lib.__name__}.config").static_block_bits(cfg.channels)
    h, w = batch.shape[1:3]
    recip = np.float32(1) / np.float32(h * w)     # the corpus's float32 bits per pixel
    bpp = []
    for frame in batch:
        _, res, grid = lib.encode_image_device(frame, cfg, seed, device=devices[0])
        bpp.append(np.float32(int(res.accum_bits.sum()) + static * grid.num_blocks) * recip)
    return Output({"bpp": np.asarray(bpp, np.float64)}, None)


def compare(got: Output, want: Output, batch) -> dict:
    """``bpp_gap``: the widest gap of a frame's bits per pixel."""
    g, w = got.totals["bpp"], want.totals["bpp"]
    return {"bpp_gap": float(np.max(np.abs(g - w))) if g.shape == w.shape else float("inf")}


def run_members(lib, batch, cfg, seed: int, params: dict, devices: tuple) -> dict:
    """No run buffer on the fixed grid."""
    return {}
