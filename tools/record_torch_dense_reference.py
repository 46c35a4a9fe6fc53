"""Record the JAX package's dense merged encode as the port's reference.

Runs the public ``limg_tpu.regions.encode_image_merged(..., use_pallas=False,
fused=False, fetch_planes=True, return_state=True)`` on the CPU (the jnp
path: every level's encode, the merge test, run coalescing on each level's
own grid) with dithering off, ladder crush at error_factor 100 unless a
case says otherwise, and writes tests/fixtures/torch_port_dense_reference.npz:

- small cases (the 70x90 and 48x64 images of tests/test_merged_fused.py
  and tests/test_merged_smoke.py, and ``make_4k(256, 384)`` RGB / RGBA) at
  1-4 levels, match and RD policies (RD at 4 levels charging LTP1's real
  region header), coalescing on and off, ``cap_frac`` 0 / 8 / -300, and
  one exhaustive ``num_factors=2`` case: the stats, ``n_runs`` and
  ``coalesce_stats``, per block the owner level, shifts, bpp, region id and
  endpoint rows, per-block hashes of the factor and decoded planes, the
  SHA-256 of the LTP1 serializer's state (``rows`` then ``q``, int32
  little-endian) and of its streams (entropy on and off), and for the two
  tiny images the state itself;
- 4K RGB and RGBA at 1 and 3 levels: the stats, ``n_runs``,
  ``coalesce_stats``, the per-block owner map and run flag, and the
  state's and streams' SHA-256 and lengths.

    JAX_PLATFORMS=cpu python tools/record_torch_dense_reference.py [--skip-4k] [--jobs N]

Each case runs in a process of its own (XLA:CPU runs out of memory maps
when one process compiles many cases); ``--jobs`` runs that many at once.
A small case takes 15-60 s, a 4K case a few minutes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.record_torch_merged_reference import (  # noqa: E402
    FULL, MERGE_KEYS, SMALL, block_hashes, config_kwargs, fused_band_image, make_4k_lane,
    per_block, smoke_image)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_dense_reference.npz")
STAT_KEYS = ("dropped_runs_at_capacity", "overflow_run_blocks", "rejected_runs")
RD_KEYS = ("kept", "rd_cost_saved", "cost_reject")


def _small(lane: str):
    return lambda: make_4k_lane(*SMALL, lane)


# name -> (image maker, levels, config overrides, policy, coalesce, cap_frac,
#          RD charges the LTP1 header, keep the state)
SMALL_CASES = {
    "band70x90_rgb_l1": (fused_band_image, 1, {}, "match", True, 0, False, True),
    "smoke48x64_rgba_l1": (smoke_image, 1, {"has_alpha": True}, "match", True, 0, False, True),
    "band70x90_rgb_l2_rd": (fused_band_image, 2, {}, "rd", True, 0, False, True),
    "smoke48x64_rgba_l3": (smoke_image, 3, {"has_alpha": True}, "match", True, 0, False, True),
    "small_rgb_l1": (_small("rgb"), 1, {}, "match", True, 0, False, False),
    "small_rgba_l1_rd": (_small("rgba"), 1, {"has_alpha": True}, "rd", True, 0, False, False),
    "small_rgb_l2": (_small("rgb"), 2, {}, "match", True, 0, False, False),
    "small_rgba_l3": (_small("rgba"), 3, {"has_alpha": True}, "match", True, 0, False, False),
    "small_rgb_l4": (_small("rgb"), 4, {}, "match", True, 0, False, False),
    "small_rgb_l3_rd": (_small("rgb"), 3, {}, "rd", True, 0, False, False),
    "small_rgba_l4_rd_hdr": (_small("rgba"), 4, {"has_alpha": True}, "rd", True, 0, True, False),
    "small_rgb_l3_nocoalesce": (_small("rgb"), 3, {}, "match", False, 0, False, False),
    "small_rgb_l2_rd_nocoalesce": (_small("rgb"), 2, {}, "rd", False, 0, False, False),
    "small_rgb_l3_cap8": (_small("rgb"), 3, {}, "match", True, 8, False, False),
    "small_rgb_l3_cap300": (_small("rgb"), 3, {}, "match", True, -300, False, False),
    "small_rgb_l2_exh_nf2": (_small("rgb"), 2, {"crush_mode": "exhaustive", "num_factors": 2},
                             "match", True, 0, False, False),
}
FULL_CASES = {
    "4k_rgb_l1": ("rgb", 1, {}),
    "4k_rgba_l1": ("rgba", 1, {"has_alpha": True}),
    "4k_rgb_l3": ("rgb", 3, {}),
    "4k_rgba_l3": ("rgba", 3, {"has_alpha": True}),
}


def state_digest(state) -> str:
    """SHA-256 of an LTP1 serializer state: its rows, then its q, as int32
    little-endian (the dense path's q is (64, NB) packed factors)."""
    h = hashlib.sha256()
    for key in ("rows", "q"):
        h.update(np.ascontiguousarray(np.asarray(state[key]), dtype="<i4").tobytes())
    return h.hexdigest()


def stream_digest(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def record_case(name: str, small_cases=None, full_cases=None) -> tuple[dict, dict]:
    """Run one case of ``small_cases`` / ``full_cases`` (default this
    file's tables); returns (arrays keyed "<name>.<field>", its meta)."""
    from limg_tpu import bitstream
    from limg_tpu.config import EncodeConfig
    from limg_tpu.regions import encode_image_merged

    small_cases = SMALL_CASES if small_cases is None else small_cases
    full_cases = FULL_CASES if full_cases is None else full_cases
    if name in small_cases:
        make, levels, over, policy, coalesce, cap_frac, hdr, keep_state = small_cases[name]
    else:
        lane, levels, over = full_cases[name]
        make, policy, coalesce, cap_frac, hdr, keep_state = (
            lambda: make_4k_lane(*FULL, lane), "match", True, 0, False, False)
    img = make()
    kw = config_kwargs(over)
    cfg = EncodeConfig(**kw)
    header = bitstream.region_header_bits(cfg.channels) if hdr else None
    t0 = time.perf_counter()
    out, state = encode_image_merged(img, cfg, seed=0, num_levels=levels, use_pallas=False,
                                     fused=False, merge_policy=policy, coalesce=coalesce,
                                     fetch_planes=True, return_state=True,
                                     rd_header_bits=header, cap_frac=cap_frac)
    keys = RD_KEYS if policy == "rd" else MERGE_KEYS
    rows = np.asarray(state["rows"])
    rec = dict(
        psnr=np.float64(out["psnr"]), mse=np.float64(out["mse"]),
        mean_bpp=np.float64(out["mean_bpp"]), avg_block_bits=np.float64(out["avg_block_bits"]),
        alive_counts=np.asarray(out["alive_counts"], np.int64),
        bits_histogram=np.asarray(out["bits_histogram"], np.int64),
        merge_stats=np.asarray([[s[k] for k in keys] for s in out["merge_stats"]],
                               np.float64).reshape(-1, len(keys)),
        n_runs=np.int64(out["n_runs"]),
        coalesce_stats=np.asarray([out["coalesce_stats"].get(k, 0) for k in STAT_KEYS],
                                  np.int64),
        owner=per_block(out["owner_px"]).astype(np.uint8),
        run_applied=np.packbits(rows[-1].astype(bool)),
        state_sha256=np.asarray(state_digest(state)),
    )
    for entropy, tag in ((True, "stream"), (False, "stream_raw")):
        blob = bitstream.serialize_from_state(state, cfg, entropy=entropy)
        rec[f"{tag}_sha256"] = np.asarray(stream_digest(blob))
        rec[f"{tag}_len"] = np.int64(len(blob))
    if name in small_cases:
        rec.update(
            shifts=per_block(out["shift"]).astype(np.uint8),
            bpp=per_block(out["bpp"]).astype(np.uint8),
            region_id=per_block(out["region_id"]).astype(np.int32),
            endpoint_rows=np.asarray(out["endpoint_rows"], np.int32),
            factors_hash=block_hashes(out["factors"]),
            decoded_hash=block_hashes(out["decoded"]),
        )
    if keep_state:
        rec.update(state_rows=rows.astype(np.int32), state_q=np.asarray(state["q"], np.int32))
    print(f"{name}: psnr {out['psnr']:.5f} bpp {out['mean_bpp']:.5f} "
          f"alive {rec['alive_counts'].tolist()} runs {int(rec['n_runs'])} "
          f"stats {rec['coalesce_stats'].tolist()} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    meta = dict(height=int(img.shape[0]), width=int(img.shape[1]), levels=levels, config=kw,
                merge_policy=policy, coalesce=coalesce, cap_frac=cap_frac,
                rd_header_bits=header, merge_keys=list(keys))
    return {f"{name}.{k}": v for k, v in rec.items()}, meta


def run_cases(argv, script: str, out_path: str, command: str, small_cases: dict,
              full_cases: dict, description: str = __doc__) -> None:
    """The command line of a recorder of ``small_cases`` and ``full_cases``:
    each case in a process of its own (``script --case NAME --part
    FILE``), ``--jobs`` at once, all into ``out_path``."""
    ap = argparse.ArgumentParser(description=description.splitlines()[0])
    ap.add_argument("--skip-4k", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--case", help="record this case only, into --part")
    ap.add_argument("--part", help="output .npz of --case")
    args = ap.parse_args(argv)
    if args.case:
        arrays, meta = record_case(args.case, small_cases, full_cases)
        np.savez(args.part, meta=np.asarray(json.dumps(meta)), **arrays)
        return

    meta = dict(
        command=command,
        jax_path="limg_tpu.regions.encode_image_merged(use_pallas=False, fused=False, "
                 "fetch_planes=True, return_state=True, seed=0) on the CPU: the dense jnp "
                 "path; streams from limg_tpu.bitstream.serialize_from_state",
        dithering="off for every case", stat_keys=list(STAT_KEYS), cases={},
    )
    names = list(small_cases) + ([] if args.skip_4k else list(full_cases))
    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name):
            part = os.path.join(tmp, f"{name}.npz")
            subprocess.run([sys.executable, script, "--case", name, "--part", part], check=True)
            return name, part

        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            for name, part in pool.map(run, names):
                with np.load(part) as f:
                    meta["cases"][name] = json.loads(str(f["meta"]))
                    arrays.update({k: f[k] for k in f.files if k != "meta"})
    arrays["meta"] = np.asarray(json.dumps(meta, sort_keys=True))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **arrays)
    print("wrote", out_path, f"({os.path.getsize(out_path)} bytes)")


def main(argv=None):
    run_cases(argv, os.path.abspath(__file__), OUT,
              "JAX_PLATFORMS=cpu python tools/record_torch_dense_reference.py",
              SMALL_CASES, FULL_CASES)


if __name__ == "__main__":
    main()
