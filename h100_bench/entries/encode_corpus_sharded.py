"""``parallel.mesh.encode_corpus_sharded``: the fixed-grid corpus encode over
the cell's cards, as its users call it.

The window calls ``encode_corpus_sharded(batch, cfg, n_devices=<cards>,
seed=seed, device="cuda")`` on a (B, H, W, 3) batch in host memory; the
corpus uploads one shard of B / cards frames to each card and returns per
frame ``psnr`` and ``bpp`` and the corpus-mean PSNR, which are the totals.
The reference and the control run ``reference.corpus.encode_corpus_sharded``
with each shard on its card (the control inside ``reference.lowered()``).
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np

from .. import control, reference
from ..harness.entry import Output
from ..reference import corpus


def call(lib, batch, cfg, seed: int, params: dict, device) -> Output:
    devices = device if isinstance(device, tuple) else (device,)
    if lib is reference or lib is control:
        with reference.lowered() if lib is control else contextlib.nullcontext():
            out = corpus.encode_corpus_sharded(batch, cfg, len(devices), seed, devices)
    else:
        mesh = importlib.import_module(f"{lib.__name__}.parallel.mesh")
        out = mesh.encode_corpus_sharded(batch, cfg, n_devices=len(devices), seed=seed,
                                         device=devices[0].type, **params)
    totals = dict(psnr=np.asarray(out["psnr"], np.float64), bpp=np.asarray(out["bpp"], np.float64),
                  mean_psnr=float(out["mean_psnr"]))
    return Output(totals, None)


def compare(got: Output, want: Output, batch) -> dict:
    """- ``bpp_gap``: the largest relative gap of a frame's bits per pixel;
    - ``psnr_gap``: the largest gap of a frame's PSNR, in dB;
    - ``mean_psnr_gap``: the gap of the corpus-mean PSNR, in dB;
    - ``frames_off``: the frames whose PSNR or bits per pixel is not the
      reference's to the bit. The frames of a batch come from one recipe and
      read within a few thousandths of a dB of each other, so a frame
      encoded on the wrong card, from another shard's frames or seed, or
      put in the wrong place by the gather keeps every gap small; it shows
      here."""
    g, w = got.totals, want.totals
    if g["bpp"].shape != w["bpp"].shape or g["psnr"].shape != w["psnr"].shape:
        return dict(bpp_gap=float("inf"), psnr_gap=float("inf"), mean_psnr_gap=float("inf"),
                    frames_off=float("inf"))
    return dict(bpp_gap=float(np.max(np.abs(g["bpp"] - w["bpp"]) / w["bpp"])),
                psnr_gap=float(np.max(np.abs(g["psnr"] - w["psnr"]))),
                mean_psnr_gap=abs(g["mean_psnr"] - w["mean_psnr"]),
                frames_off=float(np.count_nonzero((g["psnr"] != w["psnr"])
                                                  | (g["bpp"] != w["bpp"]))))


def run_members(lib, batch, cfg, seed: int, params: dict, device) -> dict:
    """No run buffer on the fixed grid."""
    return {}

