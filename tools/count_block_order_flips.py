"""Count how far the port's Morton merged encode is from the JAX package's
recorded encodes with each in-block sum order, on the CPU.

    JAX_PLATFORMS=cpu python tools/count_block_order_flips.py [natural|halving ...]

For each small case of tests/fixtures/torch_port_merged_reference.npz
(coalescing off) and torch_port_coalesce_reference.npz (the default
encode), runs ``limg_tpu_torch.encode_image_merged`` on the plain versions
with the quadtree reducers' in-block sum (ops/reduce.py ``_QuadReducer``)
in the natural layout's order (``nat_block_sum``, the port's order) or the
halving tree (``tree_sum``), and prints per case: the blocks whose owner
level, endpoints, shifts, bpp or region id differ from the fixture's; the
blocks that differ in their factor or decoded pixels alone; the blocks
whose endpoints differ by exactly 1; the blocks whose owner level differs;
and the PSNR difference (merged) or the runs against JAX's (default).
Imports no JAX; the 4K counts come from tools/profile_torch_kernels.py on
the card.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def differing(out, ref) -> tuple[int, int, int, int]:
    from tools import record_torch_merged_reference as mrec

    own_t = mrec.per_block(out["owner_px"]).astype(np.int64)
    own_j = ref("owner").astype(np.int64)
    ep = np.abs(out["endpoint_rows"].astype(np.int64)
                - ref("endpoint_rows").astype(np.int64)).max(axis=0)
    mism = ((own_t != own_j) | (ep > 0)
            | (mrec.per_block(out["shift"]) != ref("shifts")).any(axis=0)
            | (mrec.per_block(out["bpp"]) != ref("bpp"))
            | (mrec.per_block(out["region_id"]) != ref("region_id")))
    pixels = ~mism & ((mrec.block_hashes(out["factors"]) != ref("factors_hash"))
                      | (mrec.block_hashes(out["decoded"]) != ref("decoded_hash")))
    return int(mism.sum()), int(pixels.sum()), int((ep == 1).sum()), int((own_t != own_j).sum())


def count(order: str) -> dict:
    import torch

    import limg_tpu_torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.ops import fit, reduce
    from tools import record_torch_coalesce_reference as crec
    from tools import record_torch_merged_reference as mrec

    torch.set_num_threads(2)
    saved = reduce.nat_block_sum
    if order == "halving":
        reduce.nat_block_sum = lambda x: fit.tree_sum(x, -2)
    try:
        res = {}
        fx = np.load(mrec.OUT)
        for name, (make, levels, over, _) in mrec.SMALL_CASES.items():
            cfg = EncodeConfig(**mrec.config_kwargs(over))
            out = limg_tpu_torch.encode_image_merged(make(), cfg, seed=0, num_levels=levels,
                                                     coalesce=False, device="cpu")
            ref = lambda k, name=name: fx[f"{name}.{k}"]
            res[f"merged {name}"] = (*differing(out, ref),
                                     f"psnr {out['psnr'] - float(ref('psnr')):+.6f} dB")
        fx = np.load(crec.OUT)
        for name, (make, levels, over, cap_frac, _) in crec.SMALL_CASES.items():
            cfg = EncodeConfig(**mrec.config_kwargs(over))
            out = limg_tpu_torch.encode_image_merged(make(), cfg, seed=0, num_levels=levels,
                                                     cap_frac=cap_frac, device="cpu")
            ref = lambda k, name=name: fx[f"{name}.{k}"]
            res[f"default {name}"] = (*differing(out, ref),
                                      f"runs {out['n_runs']} (JAX {int(ref('n_runs'))})")
        return res
    finally:
        reduce.nat_block_sum = saved


def main():
    orders = sys.argv[1:] or ["natural", "halving"]
    print("case: differing blocks, blocks differing in pixels alone, endpoint flips of 1, "
          "owner levels off")
    for order in orders:
        for case, row in count(order).items():
            print(f"{order} {case}: {row[0]} {row[1]} {row[2]} {row[3]}  {row[4]}", flush=True)


if __name__ == "__main__":
    main()
