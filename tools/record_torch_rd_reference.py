"""Record the JAX package's RD-policy merged encode as the port's reference.

Runs the public ``limg_tpu.regions.encode_image_merged(..., use_pallas=True,
fused=True, merge_policy="rd", rd_lambda=0.01, coalesce=True,
fetch_planes=True)`` on the CPU with dithering off, ladder crush at
error_factor 100 and auto run capacity (``cap_frac=0``) unless a case says
otherwise. On the CPU each level's ``encode_blocks_pallas`` (P = 64, 256,
1024, 4096) runs in Pallas interpret mode and the coalesce stage takes its
jnp branch. Writes tests/fixtures/torch_port_rd_reference.npz:

- small cases (the 48x64 image of tests/test_merged_smoke.py, the 70x90
  edge-padded image, ``make_4k(256, 384)`` RGB and RGBA at levels 2-4,
  ``num_factors=2``, exhaustive crush, an ``rd_header_bits`` other than
  the static estimate, and a pinned ``cap_frac=-300``): ``fused_rd_pre``'s
  ``seg0``, ``is_run0`` and ``n_run_blocks``, per block the owner level,
  shifts, bpp, region id and endpoint rows, per-block hashes of the factor
  and decoded planes (the full planes for the two tiny images), the stats,
  the RD cut's ``merge_stats`` (kept, rd_cost_saved, cost_reject per
  level), ``n_runs`` and ``coalesce_stats``;
- 4K RGB and RGBA at levels 3: the stats, ``n_runs``, ``coalesce_stats``,
  the per-block owner map and the per-block run flag;
- 4K RGB and RGBA at levels 3 through the dense RD path
  (``use_pallas=False``, its jnp encode of every level and per-level band
  coalescing, dithered by threefry) with dithering off and on
  (``<name>_dense``, ``<name>_dither_dense``): the stats alone. No fused
  path dithers on the CPU; the difference of these two is JAX's own
  dither effect on the RD encode of the image, which the port's dithered
  encode is held to.

    JAX_PLATFORMS=cpu python tools/record_torch_rd_reference.py [--skip-4k]

Each case runs in a process of its own (XLA:CPU runs out of memory maps
when one process compiles every case). The meta records the path of each
case.
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
    per_block, smoke_image)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_rd_reference.npz")
STAT_KEYS = ("dropped_runs_at_capacity", "overflow_run_blocks", "rejected_runs")
RD_KEYS = ("kept", "rd_cost_saved", "cost_reject")
RD_LAMBDA = 0.01
HEADER_BITS = 64     # the rd_header_bits case: below the 110-bit static estimate


def _small(lane="rgb"):
    return lambda: make_4k_lane(*SMALL, lane)


# name -> (image maker, levels, config overrides, cap_frac, rd_header_bits,
#          keep full planes)
SMALL_CASES = {
    "smoke48x64_l2": (smoke_image, 2, {}, 0, None, True),
    "band70x90_rgb_l3": (fused_band_image, 3, {}, 0, None, True),
    "small_rgb_l2": (_small(), 2, {}, 0, None, False),
    "small_rgb_l3": (_small(), 3, {}, 0, None, False),
    "small_rgb_l4": (_small(), 4, {}, 0, None, False),
    "small_rgba_l2": (_small("rgba"), 2, {"has_alpha": True}, 0, None, False),
    "small_rgba_l3": (_small("rgba"), 3, {"has_alpha": True}, 0, None, False),
    "small_rgba_l4": (_small("rgba"), 4, {"has_alpha": True}, 0, None, False),
    "small_rgb_l3_nf2": (_small(), 3, {"num_factors": 2}, 0, None, False),
    "small_rgb_l3_exh": (_small(), 3, {"crush_mode": "exhaustive"}, 0, None, False),
    "small_rgb_l3_hdr64": (_small(), 3, {}, 0, HEADER_BITS, False),
    "small_rgb_l3_cap300": (_small(), 3, {}, -300, None, False),
}
FULL_CASES = {
    "4k_rgb_l3": ("rgb", {}),
    "4k_rgba_l3": ("rgba", {"has_alpha": True}),
}
# the dense path's cases: (fused case, dithering)
DENSE_CASES = {f"{name}_{tag}dense": (name, tag == "dither_")
               for name in FULL_CASES for tag in ("", "dither_")}


def rd_stats(out: dict) -> dict:
    """The stats of one encode, the RD cut's merge_stats as (levels-1, 3)."""
    return dict(
        psnr=np.float64(out["psnr"]), mse=np.float64(out["mse"]),
        mean_bpp=np.float64(out["mean_bpp"]),
        avg_block_bits=np.float64(out["avg_block_bits"]),
        alive_counts=np.asarray(out["alive_counts"], np.int64),
        bits_histogram=np.asarray(out["bits_histogram"], np.int64),
        merge_stats=np.asarray([[s[k] for k in RD_KEYS] for s in out["merge_stats"]],
                               np.float64).reshape(-1, len(RD_KEYS)),
        n_runs=np.int64(out["n_runs"]),
        coalesce_stats=np.asarray([out["coalesce_stats"][k] for k in STAT_KEYS], np.int64),
    )


def record_case(name: str) -> tuple[dict, dict]:
    """Run one case; returns (arrays keyed "<name>.<field>", its meta)."""
    import jax
    import jax.numpy as jnp

    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged, fused_rd_pre

    if name in DENSE_CASES:
        return record_dense_case(name)
    if name in SMALL_CASES:
        make, levels, over, cap_frac, hdr, full_planes = SMALL_CASES[name]
        img = make()
    else:
        lane, over = FULL_CASES[name]
        img, levels, cap_frac, hdr, full_planes = make_4k_lane(*FULL, lane), 3, 0, None, False
    kw = config_kwargs(over)
    cfg = EncodeConfig(**kw)
    t0 = time.perf_counter()
    out = encode_image_merged(img, cfg, seed=0, num_levels=levels, use_pallas=True, fused=True,
                              merge_policy="rd", rd_lambda=RD_LAMBDA, coalesce=True,
                              fetch_planes=True, cap_frac=cap_frac, rd_header_bits=hdr)
    state = fused_rd_pre(jnp.asarray(img), cfg, jax.random.PRNGKey(0), jnp.float32(RD_LAMBDA),
                         levels, need_q=True, header_bits=hdr)
    rec = rd_stats(out)
    rec.update(
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
    secs = time.perf_counter() - t0
    print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} "
          f"alive {rec['alive_counts'].tolist()} runs {int(rec['n_runs'])} "
          f"stats {rec['coalesce_stats'].tolist()} run blocks {int(rec['n_run_blocks'])} "
          f"merge {rec['merge_stats'].tolist()} ({secs:.1f} s)", flush=True)
    meta = dict(height=int(img.shape[0]), width=int(img.shape[1]), levels=levels, config=kw,
                cap_frac=cap_frac, rd_header_bits=hdr, seconds=round(secs, 1),
                path="fused RD path (encode_blocks_pallas in interpret mode)")
    return {f"{name}.{k}": v for k, v in rec.items()}, meta


def record_dense_case(name: str) -> tuple[dict, dict]:
    """The dense RD path on a 4K lane: its stats."""
    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged

    fused, dithering = DENSE_CASES[name]
    lane, over = FULL_CASES[fused]
    img = make_4k_lane(*FULL, lane)
    kw = config_kwargs(over, dithering=dithering)
    t0 = time.perf_counter()
    out = encode_image_merged(img, EncodeConfig(**kw), seed=0, num_levels=3, use_pallas=False,
                              fused=False, merge_policy="rd", rd_lambda=RD_LAMBDA,
                              coalesce=True, fetch_planes=False)
    secs = time.perf_counter() - t0
    rec = {k: v for k, v in rd_stats(out).items()
           if k in ("psnr", "mse", "mean_bpp", "alive_counts", "n_runs")}
    print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} alive "
          f"{rec['alive_counts'].tolist()} runs {int(rec['n_runs'])} ({secs:.1f} s)", flush=True)
    meta = dict(height=FULL[0], width=FULL[1], levels=3, config=kw, cap_frac=0,
                rd_header_bits=None, seconds=round(secs, 1),
                path="dense RD path (use_pallas=False, fused=False), full run capacity")
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
        command="JAX_PLATFORMS=cpu python tools/record_torch_rd_reference.py",
        jax_path="limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True, "
                 "merge_policy='rd', rd_lambda=0.01, coalesce=True, fetch_planes=True, "
                 "seed=0, cap_frac=<case>, rd_header_bits=<case>) on the CPU: "
                 "encode_blocks_pallas in interpret mode at every level, the coalesce "
                 "stage's jnp branch; run building from limg_tpu.regions.fused_rd_pre on "
                 "the same input",
        dithering="off for every case but the <name>_dither_dense ones",
        dense_path="limg_tpu.regions.encode_image_merged(use_pallas=False, fused=False, "
                   "merge_policy='rd', rd_lambda=0.01, coalesce=True, fetch_planes=False, "
                   "seed=0) on the CPU, dithering off and on (<name>_dense, "
                   "<name>_dither_dense)",
        rd_lambda=RD_LAMBDA, stat_keys=list(STAT_KEYS), rd_keys=list(RD_KEYS), cases={},
    )
    names = list(SMALL_CASES) + ([] if args.skip_4k else [*FULL_CASES, *DENSE_CASES])
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
