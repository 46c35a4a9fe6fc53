"""The frozen plain reference (reference/) against the JAX package's records.

The reference is a copy of the port's plain route; these tests hold it to
the committed records of the JAX package, at their sizes, with the
tolerances the port's own tests use (float sums in another order may move
a rounded endpoint by 1 and flip what depends on it):

- tests/fixtures/torch_port_reference.json: the fixed-grid encode at
  256x384, RGB and RGBA, dithering off and on;
- tests/fixtures/torch_port_merged_reference.npz: the fused merged encode
  (coalescing off) at 2-4 levels;
- tests/fixtures/torch_port_dense_reference.npz: the dense path at 1-4
  levels, both policies, with coalescing, its planes and its state.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import reference
from tools import record_torch_dense_reference as drec
from tools import record_torch_merged_reference as mrec
from tools.record_torch_reference import SIZES, case_images

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"


# ---------------------------------------------------------------------------
# fixed grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixed_fixture():
    return json.loads((FIXTURES / "torch_port_reference.json").read_text())


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("lane", ["rgb", "rgba"])
def test_fixed_grid_matches_the_jax_record(fixed_fixture, lane, dithering):
    """PSNR 0.02 dB, bpp 0.01 and bits-histogram L1 0.5% of the pixels with
    dithering off; with it on (the port's hash dither is not JAX's
    threefry) 0.3 dB and 0.1."""
    fx = fixed_fixture
    ref = fx["cases"][f"small_{lane}_{'dither' if dithering else 'nodither'}"]
    img = case_images(*SIZES["small"])[lane]
    cfg = reference.EncodeConfig(error_factor=fx["error_factor"], has_alpha=lane == "rgba",
                                 crush_mode=fx["crush_mode"], dithering=dithering)
    out = reference.encoder.encode_image(img, cfg, seed=fx["seed"], device="cpu")
    hist_l1 = int(np.abs(out["bits_histogram"] - np.asarray(ref["bits_histogram"])).sum())
    if dithering:
        assert abs(out["psnr"] - ref["psnr"]) <= 0.3
        assert abs(out["mean_bpp"] - ref["mean_bpp"]) <= 0.1
    else:
        assert abs(out["psnr"] - ref["psnr"]) <= 0.02
        assert abs(out["mean_bpp"] - ref["mean_bpp"]) <= 0.01
        assert hist_l1 <= 0.005 * img.shape[0] * img.shape[1]


# ---------------------------------------------------------------------------
# fused merged encode, coalescing off
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def merged_fixture():
    fx = np.load(FIXTURES / "torch_port_merged_reference.npz")
    return fx, json.loads(str(fx["meta"]))


@pytest.mark.parametrize("name", list(mrec.SMALL_CASES))
def test_fused_merged_matches_the_jax_record(merged_fixture, name):
    """Blocks that differ from the record (owner, endpoints, shifts, bpp,
    region id, factor or decoded pixels) at most 1% of all; PSNR 0.02 dB,
    bpp 0.01; the histogram 0.5% of the pixels plus 6 counts a pixel of a
    differing block; alive and merge counts moved only by those blocks; the
    cases recorded with their planes equal outright."""
    fx, meta = merged_fixture
    make, levels, over, full_planes = mrec.SMALL_CASES[name]
    img = make()
    cfg = reference.EncodeConfig(**mrec.config_kwargs(over))
    assert meta["cases"][name]["config"] == mrec.config_kwargs(over)

    def ref(key):
        return fx[f"{name}.{key}"]

    out = reference.encode_image_merged(img, cfg, seed=0, num_levels=levels, coalesce=False,
                                        device="cpu")
    pb = mrec.per_block
    ep_diff = np.abs(out["endpoint_rows"].astype(np.int64)
                     - ref("endpoint_rows").astype(np.int64)).max(axis=0)
    mism = ((pb(out["owner_px"]) != ref("owner")) | (ep_diff > 0)
            | (pb(out["shift"]) != ref("shifts")).any(axis=0)
            | (pb(out["bpp"]) != ref("bpp"))
            | (pb(out["region_id"]) != ref("region_id"))
            | (mrec.block_hashes(out["factors"]) != ref("factors_hash"))
            | (mrec.block_hashes(out["decoded"]) != ref("decoded_hash")))
    flips, nb, n_px = int(mism.sum()), ref("owner").size, img.shape[0] * img.shape[1]
    assert flips <= 0.01 * nb
    assert abs(out["psnr"] - float(ref("psnr"))) <= 0.02
    assert abs(out["mean_bpp"] - float(ref("mean_bpp"))) <= 0.01
    hist_l1 = int(np.abs(out["bits_histogram"] - ref("bits_histogram")).sum())
    assert hist_l1 <= 0.005 * n_px + 6 * 64 * flips
    assert np.abs(out["alive_counts"] - ref("alive_counts")).sum() <= flips
    merge = np.asarray([[s[k] for k in mrec.MERGE_KEYS] for s in out["merge_stats"]])
    assert np.abs(merge - ref("merge_stats")).sum() <= 2 * flips
    if full_planes:
        assert flips == 0
        np.testing.assert_array_equal(out["decoded"], ref("decoded"))
        np.testing.assert_array_equal(out["factors"], ref("factors"))


# ---------------------------------------------------------------------------
# dense path
# ---------------------------------------------------------------------------

# per case, the level-0 blocks whose outputs may differ from the record by
# float add order, and how many of them may change owner level (the port's
# own table, tests/test_torch_dense.py)
DENSE_FLIPS = {name: (0, 0) for name in drec.SMALL_CASES}
DENSE_FLIPS.update({
    "small_rgb_l1": (3, 0), "small_rgba_l1_rd": (9, 0), "small_rgb_l2": (14, 4),
    "small_rgba_l3": (1, 0), "small_rgb_l4": (14, 4), "small_rgb_l3_nocoalesce": (4, 4),
    "small_rgb_l3_cap8": (14, 4), "small_rgb_l3_cap300": (14, 4),
})
PSNR_DB, BPP = 1e-3, 1e-4
MERGE_FLIP_PSNR_DB, MERGE_FLIP_BPP = 5e-3, 5e-3


@pytest.fixture(scope="module")
def dense_fixture():
    fx = np.load(FIXTURES / "torch_port_dense_reference.npz")
    return fx, json.loads(str(fx["meta"]))


@pytest.mark.parametrize("name", list(drec.SMALL_CASES))
def test_dense_path_matches_the_jax_record(dense_fixture, name):
    fx, meta = dense_fixture
    m = meta["cases"][name]
    cfg = reference.EncodeConfig(**m["config"])
    out, state = reference.encode_image_merged(
        drec.SMALL_CASES[name][0](), cfg, seed=0, num_levels=m["levels"],
        merge_policy=m["merge_policy"], coalesce=m["coalesce"], cap_frac=m["cap_frac"],
        rd_header_bits=m["rd_header_bits"], return_state=True, fused=False, device="cpu")
    pb = mrec.per_block
    nb = pb(out["owner_px"]).size
    run = np.unpackbits(fx[f"{name}.run_applied"])[:nb].astype(bool)
    diff = ((pb(out["owner_px"]) != fx[f"{name}.owner"])
            | (pb(out["shift"]) != fx[f"{name}.shifts"]).any(axis=0)
            | (pb(out["bpp"]) != fx[f"{name}.bpp"])
            | (pb(out["region_id"]) != fx[f"{name}.region_id"])
            | (out["endpoint_rows"] != fx[f"{name}.endpoint_rows"]).any(axis=0)
            | (state["rows"][-1].astype(bool) != run)
            | (mrec.block_hashes(out["factors"]) != fx[f"{name}.factors_hash"])
            | (mrec.block_hashes(out["decoded"]) != fx[f"{name}.decoded_hash"]))
    flipped = np.nonzero(diff)[0]
    n_flips, n_owner = DENSE_FLIPS[name]
    assert flipped.size <= n_flips, f"{name}: blocks that differ: {flipped[:20]}"
    owner_flips = int((pb(out["owner_px"]) != fx[f"{name}.owner"]).sum())
    assert owner_flips <= n_owner
    psnr_db, bpp = (MERGE_FLIP_PSNR_DB, MERGE_FLIP_BPP) if owner_flips else (PSNR_DB, BPP)
    assert abs(out["psnr"] - float(fx[f"{name}.psnr"])) <= psnr_db
    assert abs(out["mean_bpp"] - float(fx[f"{name}.mean_bpp"])) <= bpp
    np.testing.assert_allclose(out["alive_counts"], fx[f"{name}.alive_counts"],
                               atol=owner_flips // 4)
    hist_l1 = int(np.abs(out["bits_histogram"] - fx[f"{name}.bits_histogram"]).sum())
    assert hist_l1 <= 2 * 3 * 64 * flipped.size
    assert abs(out["n_runs"] - int(fx[f"{name}.n_runs"])) <= (flipped.size > 0)
    stats = np.asarray([out["coalesce_stats"].get(k, 0) for k in drec.STAT_KEYS])
    assert (np.abs(stats - fx[f"{name}.coalesce_stats"]) <= flipped.size).all()
    keys = m["merge_keys"]
    got = np.asarray([[s[k] for k in keys] for s in out["merge_stats"]]).reshape(-1, len(keys))
    np.testing.assert_allclose(got, fx[f"{name}.merge_stats"].reshape(-1, len(keys)),
                               rtol=1e-4, atol=owner_flips)
    if flipped.size == 0 and f"{name}.state_rows" in fx:
        np.testing.assert_array_equal(state["rows"], fx[f"{name}.state_rows"])
        np.testing.assert_array_equal(state["q"], fx[f"{name}.state_q"])
