"""Record the JAX fused merged encode (coalescing off) as the port's reference.

Runs the public ``limg_tpu.regions.encode_image_merged(..., use_pallas=True,
fused=True, coalesce=False, fetch_planes=True)`` on the CPU (the Pallas
kernels in interpret mode) with dithering off, ladder crush at
error_factor 100 unless a case says otherwise, and writes
tests/fixtures/torch_port_merged_reference.npz:

- small cases (the images of tests/test_merged_fused.py and
  tests/test_merged_smoke.py, and ``make_4k(256, 384)`` at levels 2-4,
  RGB and RGBA, ``num_factors=2`` and exhaustive crush): per block the
  owner level, shifts, bpp, region id and endpoint rows, per-block hashes
  of the factor and decoded planes (the full planes for the three tiny
  images), and the stats;
- 4K RGB and RGBA at levels 3: the stats and the per-block owner map;
- 4K RGB and RGBA with dithering on, from the dense jnp path (the fused
  path's TPU PRNG has no interpret lowering): PSNR and mean bpp only.

    JAX_PLATFORMS=cpu python tools/record_torch_merged_reference.py [--skip-4k]

Takes a few minutes (about 15 s per small case, 25 s per 4K fused case and
45 s per 4K dense case). The image recipes and ``block_hashes`` are plain
numpy, so the tests and chip_smoke.py import them without JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_merged_reference.npz")
ERROR_FACTOR = 100
SMALL = (256, 384)
FULL = (2160, 3840)
_HASH_WEIGHTS = np.random.default_rng(0x5EED).integers(
    1, 2**63, size=64 * 4, dtype=np.uint64) | np.uint64(1)


def _test_image(rng, h, w):
    """tests/conftest.make_test_image's recipe (RGBA, alpha 255)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 40 + 150 * x / w + 8 * rng.standard_normal((h, w))
    g = 30 + 180 * y / h + 8 * rng.standard_normal((h, w))
    b = 128 + 90 * np.sin(x / 7.0) * np.cos(y / 5.0) + 8 * rng.standard_normal((h, w))
    img = np.stack([r, g, b, np.full((h, w), 255.0)], axis=-1)
    img[h // 3: h // 2, w // 4: w // 2, :3] = [220, 40, 180]
    return np.clip(img, 0, 255).astype(np.uint8)


def fused_band_image():
    """tests/test_merged_fused.py:51-54: 70x90 RGB, edge-padded, flat band."""
    img = _test_image(np.random.default_rng(881), 70, 90)[:, :, :3].copy()
    img[0:32, :, :3] = [40, 90, 200]
    return img


def flat_image():
    """tests/test_merged_fused.py:70-79: 40x48 constant RGB."""
    return np.full((40, 48, 3), [120, 60, 200], np.uint8)


def smoke_image():
    """tests/test_merged_smoke.py:19-37: 48x64 bands, RGBA (alpha 255)."""
    rng = np.random.default_rng(42)
    h, w = 48, 64
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    img[0:8, :, :3] = [60, 110, 200]
    img[8:16, :, :3] = np.clip(120 + rng.integers(-60, 61, (8, w, 3)), 0, 255)
    img[16:24, :, :3] = [200, 160, 40]
    img[24:32, :, :3] = np.clip(90 + rng.integers(-60, 61, (8, w, 3)), 0, 255)
    img[32:48, :, :3] = [30, 190, 120]
    return img


def make_4k_lane(h: int, w: int, lane: str):
    """make_4k(h, w) RGB, or with bench.py's gradient alpha for "rgba"."""
    sys.path.insert(0, ROOT)
    from tools.record_torch_reference import case_images

    return case_images(h, w)[lane]


# name -> (image maker, levels, config overrides, keep full planes)
SMALL_CASES = {
    "band70x90_rgb_l3": (fused_band_image, 3, {}, True),
    "flat40x48_rgb_l2": (flat_image, 2, {}, True),
    "smoke48x64_rgba_l2": (smoke_image, 2, {"has_alpha": True}, True),
    "small_rgb_l3": (lambda: make_4k_lane(*SMALL, "rgb"), 3, {}, False),
    "small_rgba_l3": (lambda: make_4k_lane(*SMALL, "rgba"), 3, {"has_alpha": True}, False),
    "small_rgb_l2": (lambda: make_4k_lane(*SMALL, "rgb"), 2, {}, False),
    "small_rgb_l4": (lambda: make_4k_lane(*SMALL, "rgb"), 4, {}, False),
    "small_rgb_l3_nf2": (lambda: make_4k_lane(*SMALL, "rgb"), 3, {"num_factors": 2}, False),
    "small_rgb_l3_exh": (lambda: make_4k_lane(*SMALL, "rgb"), 3,
                         {"crush_mode": "exhaustive"}, False),
}
FULL_CASES = {
    "4k_rgb_l3": ("rgb", {}),
    "4k_rgba_l3": ("rgba", {"has_alpha": True}),
}


def config_kwargs(overrides: dict, dithering: bool = False) -> dict:
    kw = dict(error_factor=ERROR_FACTOR, crush_mode="ladder", dithering=dithering)
    kw.update(overrides)
    return kw


def block_hashes(plane: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 plane -> (NB,) uint64 hash of each 8x8 block's bytes,
    row-major block order, edge blocks zero-padded. A random linear hash
    mod 2^64: equal blocks give equal hashes, and unequal ones collide with
    negligible probability."""
    h, w, c = plane.shape
    by, bx = -(-h // 8), -(-w // 8)
    padded = np.zeros((by * 8, bx * 8, c), np.uint8)
    padded[:h, :w] = plane
    blocks = padded.reshape(by, 8, bx, 8, c).transpose(0, 2, 1, 3, 4).reshape(by * bx, 64 * c)
    with np.errstate(over="ignore"):
        return (blocks.astype(np.uint64) * _HASH_WEIGHTS[:64 * c]).sum(axis=1, dtype=np.uint64)


def per_block(plane: np.ndarray) -> np.ndarray:
    """Per-pixel plane (..., H, W) of block-constant values -> (..., NB)."""
    v = plane[..., ::8, ::8]
    return v.reshape(*v.shape[:-2], -1)


def stats_of(out: dict) -> dict:
    return dict(
        psnr=np.float64(out["psnr"]), mse=np.float64(out["mse"]),
        mean_bpp=np.float64(out["mean_bpp"]),
        avg_block_bits=np.float64(out["avg_block_bits"]),
        alive_counts=np.asarray(out["alive_counts"], np.int64),
        bits_histogram=np.asarray(out["bits_histogram"], np.int64),
        merge_stats=np.asarray([[s[k] for k in MERGE_KEYS] for s in out["merge_stats"]],
                               np.float64).reshape(-1, len(MERGE_KEYS)),
    )


MERGE_KEYS = ("fast_accept", "avg_diff_reject", "range_reject", "ratio_reject",
              "probe_reject")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-4k", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged

    arrays = {}
    meta = dict(
        command="JAX_PLATFORMS=cpu python tools/record_torch_merged_reference.py",
        jax_path="limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True, "
                 "coalesce=False, fetch_planes=True, seed=0) on the CPU, Pallas "
                 "interpret mode, fused_layout='morton'",
        dithering="off for every fused case (the TPU PRNG has no interpret lowering)",
        dither_on_source="limg_tpu.regions.encode_image_merged(use_pallas=False, "
                         "fused=False, coalesce=False, seed=0): the dense jnp path, "
                         "threefry dither; PSNR and mean bpp only",
        merge_keys=list(MERGE_KEYS), cases={},
    )

    def run(name, img, levels, kw, dense=False):
        t0 = time.perf_counter()
        out = encode_image_merged(img, EncodeConfig(**kw), seed=0, num_levels=levels,
                                  use_pallas=not dense, fused=not dense, coalesce=False,
                                  fetch_planes=not dense)
        print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} "
              f"alive {np.asarray(out['alive_counts']).tolist()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        meta["cases"][name] = dict(height=int(img.shape[0]), width=int(img.shape[1]),
                                   levels=levels, config=kw,
                                   path="dense" if dense else "fused")
        return out

    for name, (make, levels, over, full_planes) in SMALL_CASES.items():
        img = make()
        out = run(name, img, levels, config_kwargs(over))
        rec = stats_of(out)
        rec.update(
            owner=per_block(out["owner_px"]).astype(np.uint8),
            shifts=per_block(out["shift"]).astype(np.uint8),
            bpp=per_block(out["bpp"]).astype(np.uint8),
            region_id=per_block(out["region_id"]).astype(np.int32),
            endpoint_rows=np.asarray(out["endpoint_rows"], np.int32),
            factors_hash=block_hashes(out["factors"]),
            decoded_hash=block_hashes(out["decoded"]),
        )
        if full_planes:
            rec.update(factors=out["factors"], decoded=out["decoded"])
        arrays.update({f"{name}.{k}": v for k, v in rec.items()})

    if not args.skip_4k:
        for name, (lane, over) in FULL_CASES.items():
            img = make_4k_lane(*FULL, lane)
            out = run(name, img, 3, config_kwargs(over))
            rec = stats_of(out)
            rec["owner"] = per_block(out["owner_px"]).astype(np.uint8)
            arrays.update({f"{name}.{k}": v for k, v in rec.items()})
            dname = f"{name}_dither_dense"
            out = run(dname, img, 3, config_kwargs(over, dithering=True), dense=True)
            arrays.update({f"{dname}.psnr": np.float64(out["psnr"]),
                           f"{dname}.mean_bpp": np.float64(out["mean_bpp"])})

    arrays["meta"] = np.asarray(json.dumps(meta, sort_keys=True))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print("wrote", OUT, f"({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
