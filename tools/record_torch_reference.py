"""Record the JAX fixed-grid encode's stats as the PyTorch port's reference.

Runs ``limg_tpu.encoder.encode_image(..., use_pallas=False)`` (the jnp
path) on the CPU, ladder crush at error_factor 100, with dithering off and
on, for ``make_4k()`` RGB and the same image with bench.py's gradient alpha
as RGBA, plus a small cut (``make_4k(256, 384)``) that the CPU tests can
afford. Writes PSNR, mse, mean bpp, average block bits and the bits
histogram of each case to tests/fixtures/torch_port_reference.json, which
``chip_smoke.py`` and tests/test_torch_fixture.py hold the port against.

    JAX_PLATFORMS=cpu python tools/record_torch_reference.py [--sizes small,4k]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_reference.json")
SIZES = {"small": (256, 384), "4k": (2160, 3840)}
ERROR_FACTOR = 100
CRUSH_MODE = "ladder"


def gradient_alpha(h: int, w: int) -> np.ndarray:
    """bench.py's structured alpha plane for the RGBA lane."""
    return (255 - (np.arange(h, dtype=np.int32)[:, None] * 96 // h)
            - (np.arange(w, dtype=np.int32)[None, :] * 32 // w)).astype(np.uint8)


def case_images(h: int, w: int):
    """{"rgb": (H, W, 3), "rgba": (H, W, 4)} inputs of one size."""
    sys.path.insert(0, ROOT)
    from tools.make_test_image import make_4k

    rgb = make_4k(h, w)
    return {"rgb": rgb,
            "rgba": np.concatenate([rgb, gradient_alpha(h, w)[..., None]], axis=-1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="small,4k")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from limg_tpu.config import EncodeConfig
    from limg_tpu.encoder import encode_image

    doc = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            doc = json.load(f)
    doc.update(
        source="limg_tpu.encoder.encode_image(use_pallas=False) on the CPU "
               "(jnp path, threefry dither), tools/record_torch_reference.py",
        error_factor=ERROR_FACTOR, crush_mode=CRUSH_MODE, seed=0,
    )
    cases = doc.setdefault("cases", {})
    for size in args.sizes.split(","):
        h, w = SIZES[size]
        for lane, img in case_images(h, w).items():
            for dithering in (False, True):
                cfg = EncodeConfig(error_factor=ERROR_FACTOR, has_alpha=lane == "rgba",
                                   crush_mode=CRUSH_MODE, dithering=dithering)
                t0 = time.perf_counter()
                out = encode_image(img, cfg, seed=0, use_pallas=False)
                name = f"{size}_{lane}_{'dither' if dithering else 'nodither'}"
                cases[name] = dict(
                    height=h, width=w, channels=cfg.channels, dithering=dithering,
                    psnr=out["psnr"], mse=out["mse"], mean_bpp=out["mean_bpp"],
                    avg_block_bits=out["avg_block_bits"],
                    bits_histogram=np.asarray(out["bits_histogram"]).tolist(),
                )
                print(f"{name}: psnr {out['psnr']:.4f} bpp {out['mean_bpp']:.4f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()
