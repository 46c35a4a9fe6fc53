"""Record the JAX package's natural-layout merged encode as the port's reference.

Runs the public ``limg_tpu.regions.encode_image_merged(..., use_pallas=True,
fused=True, fused_layout="natural", return_state=True, fetch_planes=True)``
on the CPU with dithering off, ladder crush at error_factor 100 and auto run
capacity (``cap_frac=0``) unless a case says otherwise. On the CPU
``fit_levels_natural`` and ``owner_crush_natural`` run in Pallas interpret
mode and the coalesce stage takes its jnp branch. Writes
tests/fixtures/torch_port_natural_reference.npz:

- per case (the 48x64 image of tests/test_merged_smoke.py, the 70x150 image
  of tests/test_natural.py with its flat band, the 40x72 image of its
  serializer test, and ``make_4k(256, 384)``; levels 2-4, RGB and RGBA,
  coalescing on and off): per block the owner level, shifts, bpp, region
  id and endpoint rows, per-block hashes of the factor and decoded planes
  (the full planes for the three tiny images), the stats, ``n_runs``,
  ``coalesce_stats`` and the serializer state (``state_rows``, and
  ``state_q`` in full for the tiny images, as per-block hashes otherwise);
  with coalescing also ``fused_merged_pre(fused_layout="natural")``'s
  ``seg0`` and ``is_run0``;
- 4K RGB and RGBA at levels 3 (``4k_rgb_l3``, ``4k_rgba_l3``): the stats,
  ``n_runs``, ``coalesce_stats``, the per-block owner map and run flag;
- ``crush_eval_rgb`` / ``crush_eval_rgba``: ``crush_eval_rows_k_pallas``
  (the segment crush's batched evaluation, interpret mode) on the seeded
  inputs of ``crush_eval_inputs``: its (K, N) pixel maxima and block errors.

    JAX_PLATFORMS=cpu python tools/record_torch_natural_reference.py [--skip-4k]

Each case runs in a process of its own (XLA:CPU runs out of memory maps
when one process compiles every case); ``--case NAME --part out.npz``
records one. ``crush_eval_inputs`` and the image recipes are plain numpy, so
the tests import them without JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.record_torch_merged_reference import (  # noqa: E402
    FULL, SMALL, _test_image, block_hashes, config_kwargs, make_4k_lane, per_block, smoke_image,
    stats_of)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_natural_reference.npz")
STAT_KEYS = ("dropped_runs_at_capacity", "overflow_run_blocks", "rejected_runs")
CRUSH_EVAL_K = 8
CRUSH_EVAL_N = 300        # not a multiple of the TPU kernel's 256-lane tile


def natural_band_image(has_alpha: bool):
    """tests/test_natural.py:34-37: 70x150, a flat band over the top 32 rows."""
    img = _test_image(np.random.default_rng(881), 70, 150)
    if not has_alpha:
        img = img[:, :, :3].copy()
    img[0:32, :, :3] = [40, 90, 200]
    return img


def serializer_image():
    """tests/test_natural.py:51-52: 40x72 RGBA, a flat band over 16 rows."""
    img = _test_image(np.random.default_rng(7), 40, 72)
    img[:16, :, :3] = [120, 60, 200]
    return img


def _small(lane="rgb"):
    return lambda: make_4k_lane(*SMALL, lane)


# name -> (image maker, levels, config overrides, coalesce, keep full planes)
CASES = {
    "smoke48x64_l2": (smoke_image, 2, {}, True, True),
    "band70x150_rgb_l3": (lambda: natural_band_image(False), 3, {}, True, True),
    "band70x150_rgba_l3": (lambda: natural_band_image(True), 3, {"has_alpha": True}, True,
                           True),
    "band70x150_rgb_l3_nocoal": (lambda: natural_band_image(False), 3, {}, False, True),
    "ser40x72_l2": (serializer_image, 2, {}, True, True),
    "small_rgb_l2": (_small(), 2, {}, True, False),
    "small_rgb_l3": (_small(), 3, {}, True, False),
    "small_rgb_l4": (_small(), 4, {}, True, False),
    "small_rgba_l3": (_small("rgba"), 3, {"has_alpha": True}, True, False),
    "small_rgba_l4": (_small("rgba"), 4, {"has_alpha": True}, True, False),
    "small_rgb_l3_nocoal": (_small(), 3, {}, False, False),
    "small_rgba_l2_nocoal": (_small("rgba"), 2, {"has_alpha": True}, False, False),
}
FULL_CASES = {
    "4k_rgb_l3": ("rgb", {}),
    "4k_rgba_l3": ("rgba", {"has_alpha": True}),
}
CRUSH_EVAL_CASES = {"crush_eval_rgb": 3, "crush_eval_rgba": 4}


def crush_eval_inputs(channels: int, n: int = CRUSH_EVAL_N, k: int = CRUSH_EVAL_K,
                      seed: int = 11):
    """Seeded inputs of the segment crush's evaluation: packed words and
    mask (64, n) i32, packed u8 factors f8 (64, n) i32, six endpoint rows
    (6, ch, n) i32 (dirA min/max in [0, 255], the B/C offsets and ends in
    [-64, 64)) and candidate shifts (k, 3, n) i32 in 0..8."""
    rng = np.random.default_rng(seed + channels)
    words = rng.integers(0, 2**32, size=(64, n), dtype=np.uint64).astype(np.uint32)
    if channels == 3:
        words &= np.uint32(0x00FFFFFF)
    packed = words.view(np.int32)
    mask = (rng.random((64, n)) < 0.9).astype(np.int32)
    mask[:, :4] = 1
    f8 = rng.integers(0, 256, size=(3, 64, n)).astype(np.int32)
    f8_packed = f8[0] | (f8[1] << 8) | (f8[2] << 16)
    eps = np.concatenate([rng.integers(0, 256, size=(2, channels, n)),
                          rng.integers(-64, 64, size=(4, channels, n))]).astype(np.int32)
    shifts = rng.integers(0, 9, size=(k, 3, n)).astype(np.int32)
    return packed, mask, f8_packed, eps, shifts


def record_crush_eval(name: str) -> tuple[dict, dict]:
    import jax.numpy as jnp

    from limg_tpu.pallas_kernels.encode_fixed import crush_eval_rows_k_pallas

    ch = CRUSH_EVAL_CASES[name]
    packed, mask, f8_packed, eps, shifts = crush_eval_inputs(ch)
    t0 = time.perf_counter()
    pm, be = crush_eval_rows_k_pallas(jnp.asarray(packed), jnp.asarray(mask),
                                      jnp.asarray(f8_packed), [jnp.asarray(e) for e in eps],
                                      jnp.asarray(shifts), ch, interpret=True)
    secs = time.perf_counter() - t0
    print(f"{name}: pm sum {int(np.asarray(pm).sum())} ({secs:.1f} s)", flush=True)
    rec = dict(pm=np.asarray(pm, np.int32), be=np.asarray(be, np.int32))
    meta = dict(channels=ch, n=CRUSH_EVAL_N, k=CRUSH_EVAL_K, seconds=round(secs, 1),
                path="crush_eval_rows_k_pallas(interpret=True) on crush_eval_inputs")
    return {f"{name}.{k}": v for k, v in rec.items()}, meta


def record_case(name: str) -> tuple[dict, dict]:
    """Run one case; returns (arrays keyed "<name>.<field>", its meta)."""
    import jax
    import jax.numpy as jnp

    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged, fused_merged_pre

    if name in CRUSH_EVAL_CASES:
        return record_crush_eval(name)
    if name in FULL_CASES:
        return record_4k(name)
    make, levels, over, coalesce, full_planes = CASES[name]
    img = make()
    kw = config_kwargs(over)
    cfg = EncodeConfig(**kw)
    t0 = time.perf_counter()
    out, state = encode_image_merged(img, cfg, seed=0, num_levels=levels, use_pallas=True,
                                     fused=True, coalesce=coalesce, fetch_planes=True,
                                     return_state=True, fused_layout="natural")
    rec = stats_of(out)
    q = np.asarray(state["q"])                                       # (3, 64, NB) u8
    rec.update(
        n_runs=np.int64(out["n_runs"]),
        coalesce_stats=np.asarray([out["coalesce_stats"].get(k, 0) for k in STAT_KEYS],
                                  np.int64),
        owner=per_block(out["owner_px"]).astype(np.uint8),
        shifts=per_block(out["shift"]).astype(np.uint8),
        bpp=per_block(out["bpp"]).astype(np.uint8),
        region_id=per_block(out["region_id"]).astype(np.int32),
        endpoint_rows=np.asarray(out["endpoint_rows"], np.int32),
        factors_hash=block_hashes(out["factors"]),
        decoded_hash=block_hashes(out["decoded"]),
        state_rows=np.asarray(state["rows"], np.int32),
        state_q_hash=block_hashes(q.transpose(2, 1, 0).reshape(-1, 8, 3)),
    )
    if coalesce:
        pre = fused_merged_pre(jnp.asarray(img), cfg, jax.random.PRNGKey(0), levels,
                               need_q=True, fused_layout="natural")
        rec.update(seg0=np.asarray(pre["seg0"]).astype(np.int32),
                   is_run0=np.asarray(pre["is_run0"]).astype(np.uint8))
    if full_planes:
        rec.update(factors=out["factors"], decoded=out["decoded"], state_q=q)
    secs = time.perf_counter() - t0
    print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} "
          f"alive {rec['alive_counts'].tolist()} runs {int(rec['n_runs'])} "
          f"stats {rec['coalesce_stats'].tolist()} ({secs:.1f} s)", flush=True)
    meta = dict(height=int(img.shape[0]), width=int(img.shape[1]), levels=levels, config=kw,
                coalesce=coalesce, seconds=round(secs, 1))
    return {f"{name}.{k}": v for k, v in rec.items()}, meta


def record_4k(name: str) -> tuple[dict, dict]:
    """One 4K lane at 3 levels: its stats, runs, owner map and run flags."""
    import jax
    import jax.numpy as jnp

    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged, fused_merged_pre

    lane, over = FULL_CASES[name]
    img = make_4k_lane(*FULL, lane)
    kw = config_kwargs(over)
    cfg = EncodeConfig(**kw)
    t0 = time.perf_counter()
    out = encode_image_merged(img, cfg, seed=0, num_levels=3, use_pallas=True, fused=True,
                              fetch_planes=True, fused_layout="natural")
    pre = fused_merged_pre(jnp.asarray(img), cfg, jax.random.PRNGKey(0), 3, need_q=False,
                           fused_layout="natural")
    rec = stats_of(out)
    rec.update(
        n_runs=np.int64(out["n_runs"]),
        coalesce_stats=np.asarray([out["coalesce_stats"][k] for k in STAT_KEYS], np.int64),
        owner=per_block(out["owner_px"]).astype(np.uint8),
        is_run0=np.asarray(pre["is_run0"]).astype(np.uint8),
    )
    secs = time.perf_counter() - t0
    print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} "
          f"alive {rec['alive_counts'].tolist()} runs {int(rec['n_runs'])} "
          f"stats {rec['coalesce_stats'].tolist()} ({secs:.1f} s)", flush=True)
    meta = dict(height=FULL[0], width=FULL[1], levels=3, config=kw, coalesce=True,
                seconds=round(secs, 1))
    return {f"{name}.{k}": v for k, v in rec.items()}, meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-4k", action="store_true")
    ap.add_argument("--case", help="record this case only, into --part")
    ap.add_argument("--part", help="output .npz of --case")
    args = ap.parse_args(argv)
    if args.case:
        arrays, meta = record_case(args.case)
        np.savez(args.part, meta=np.asarray(json.dumps(meta)), **arrays)
        return

    arrays = {}
    meta = dict(
        command="JAX_PLATFORMS=cpu python tools/record_torch_natural_reference.py",
        jax_path="limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True, "
                 "fused_layout='natural', return_state=True, fetch_planes=True, seed=0, "
                 "cap_frac=0, coalesce=<case>) on the CPU: fit_levels_natural and "
                 "owner_crush_natural in Pallas interpret mode, the coalesce stage's jnp "
                 "branch; run building from limg_tpu.regions.fused_merged_pre(fused_layout="
                 "'natural') on the same input",
        dithering="off for every case",
        crush_eval="limg_tpu.pallas_kernels.encode_fixed.crush_eval_rows_k_pallas("
                   "interpret=True) on crush_eval_inputs(channels)",
        stat_keys=list(STAT_KEYS), cases={},
    )
    with tempfile.TemporaryDirectory() as tmp:
        for name in [*CASES, *CRUSH_EVAL_CASES, *([] if args.skip_4k else FULL_CASES)]:
            part = os.path.join(tmp, f"{name}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--case", name,
                            "--part", part], check=True)
            with np.load(part) as f:
                meta["cases"][name] = json.loads(str(f["meta"]))
                arrays.update({k: f[k] for k in f.files if k != "meta"})
    arrays["meta"] = np.asarray(json.dumps(meta, sort_keys=True))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print("wrote", OUT, f"({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
