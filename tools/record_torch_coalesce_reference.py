"""Record the JAX package's default merged encode (run coalescing on) as the
port's reference.

Runs the public ``limg_tpu.regions.encode_image_merged(..., use_pallas=True,
fused=True, coalesce=True, fetch_planes=True)`` on the CPU with dithering
off, ladder crush at error_factor 100 and auto run capacity (``cap_frac=0``)
unless a case says otherwise. On the CPU the fit and owner-crush kernels run
in Pallas interpret mode and the coalesce stage takes its jnp branch (the
composition tests/test_segment_kernel.py holds bit-identical to the segment
kernel). Writes tests/fixtures/torch_port_coalesce_reference.npz:

- small cases (the 48x64 image of tests/test_merged_smoke.py, the 70x90
  edge-padded image, and ``make_4k(256, 384)`` RGB / RGBA at levels 2-4,
  ``num_factors=2``, exhaustive crush, ``cap_frac=8`` and a pinned
  ``cap_frac=-300``): ``fused_merged_pre``'s ``seg0``, ``is_run0`` and
  ``n_run_blocks`` (run building alone), per block the owner level,
  shifts, bpp, region id and endpoint rows, per-block hashes of the factor
  and decoded planes (the full planes for the two tiny images), the stats,
  ``n_runs`` and ``coalesce_stats``;
- 4K RGB and RGBA at levels 3: the stats, ``n_runs``, ``coalesce_stats``,
  the per-block owner map and the per-block run flag.

    JAX_PLATFORMS=cpu python tools/record_torch_coalesce_reference.py [--skip-4k]

Each case runs in a process of its own (XLA:CPU runs out of memory maps
when one process compiles every case). Takes about ten minutes (about
35 s per small case and 70 s per 4K case).
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
    FULL, SMALL, block_hashes, config_kwargs, fused_band_image, make_4k_lane,
    per_block, smoke_image, stats_of)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_coalesce_reference.npz")
STAT_KEYS = ("dropped_runs_at_capacity", "overflow_run_blocks", "rejected_runs")


def _small():
    return make_4k_lane(*SMALL, "rgb")


# name -> (image maker, levels, config overrides, cap_frac, keep full planes)
SMALL_CASES = {
    "smoke48x64_l2": (smoke_image, 2, {}, 0, True),
    "band70x90_rgb_l3": (fused_band_image, 3, {}, 0, True),
    "small_rgb_l3": (_small, 3, {}, 0, False),
    "small_rgba_l3": (lambda: make_4k_lane(*SMALL, "rgba"), 3, {"has_alpha": True}, 0, False),
    "small_rgb_l2": (_small, 2, {}, 0, False),
    "small_rgb_l4": (_small, 4, {}, 0, False),
    "small_rgb_l3_nf2": (_small, 3, {"num_factors": 2}, 0, False),
    "small_rgb_l3_exh": (_small, 3, {"crush_mode": "exhaustive"}, 0, False),
    "small_rgb_l3_cap8": (_small, 3, {}, 8, False),
    "small_rgb_l3_cap300": (_small, 3, {}, -300, False),
}
FULL_CASES = {
    "4k_rgb_l3": ("rgb", {}),
    "4k_rgba_l3": ("rgba", {"has_alpha": True}),
}


def record_case(name: str) -> tuple[dict, dict]:
    """Run one case; returns (arrays keyed "<name>.<field>", its meta)."""
    import jax
    import jax.numpy as jnp

    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged, fused_merged_pre

    if name in SMALL_CASES:
        make, levels, over, cap_frac, full_planes = SMALL_CASES[name]
        img = make()
    else:
        lane, over = FULL_CASES[name]
        img, levels, cap_frac, full_planes = make_4k_lane(*FULL, lane), 3, 0, False
    kw = config_kwargs(over)
    cfg = EncodeConfig(**kw)
    t0 = time.perf_counter()
    out = encode_image_merged(img, cfg, seed=0, num_levels=levels, use_pallas=True, fused=True,
                              coalesce=True, fetch_planes=True, cap_frac=cap_frac)
    state = fused_merged_pre(jnp.asarray(img), cfg, jax.random.PRNGKey(0), levels, need_q=True)
    rec = stats_of(out)
    rec.update(
        n_runs=np.int64(out["n_runs"]),
        coalesce_stats=np.asarray([out["coalesce_stats"][k] for k in STAT_KEYS], np.int64),
        owner=per_block(out["owner_px"]).astype(np.uint8),
        is_run0=np.asarray(state["is_run0"]).astype(np.uint8),
        n_run_blocks=np.int64(int(np.asarray(state["n_run_blocks"]))),
    )
    if name in SMALL_CASES:
        rec.update(
            seg0=np.asarray(state["seg0"]).astype(np.int32),
            shifts=per_block(out["shift"]).astype(np.uint8),
            bpp=per_block(out["bpp"]).astype(np.uint8),
            region_id=per_block(out["region_id"]).astype(np.int32),
            endpoint_rows=np.asarray(out["endpoint_rows"], np.int32),
            factors_hash=block_hashes(out["factors"]),
            decoded_hash=block_hashes(out["decoded"]),
        )
    if full_planes:
        rec.update(factors=out["factors"], decoded=out["decoded"])
    print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} "
          f"alive {rec['alive_counts'].tolist()} runs {int(rec['n_runs'])} "
          f"stats {rec['coalesce_stats'].tolist()} run blocks {int(rec['n_run_blocks'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    meta = dict(height=int(img.shape[0]), width=int(img.shape[1]), levels=levels, config=kw,
                cap_frac=cap_frac)
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
        command="JAX_PLATFORMS=cpu python tools/record_torch_coalesce_reference.py",
        jax_path="limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True, "
                 "coalesce=True, fetch_planes=True, seed=0, cap_frac=<case>) on the CPU: "
                 "fit/owner-crush Pallas kernels in interpret mode, the coalesce stage's "
                 "jnp branch, fused_layout='morton'; run building from "
                 "limg_tpu.regions.fused_merged_pre on the same input",
        dithering="off for every case",
        stat_keys=list(STAT_KEYS), cases={},
    )
    names = list(SMALL_CASES) + ([] if args.skip_4k else list(FULL_CASES))
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
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
