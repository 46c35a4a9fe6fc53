"""limg_tpu_torch's RD merge policy (``encode_image_merged(merge_policy="rd")``)
vs the JAX package, on the CPU.

tests/fixtures/torch_port_rd_reference.npz holds the public output of
``limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True,
merge_policy="rd", rd_lambda=0.01, coalesce=True)`` and the run building of
``fused_rd_pre`` (tools/record_torch_rd_reference.py; every level's
``encode_blocks_pallas`` in interpret mode, dithering off). On the CPU the
port runs its kernels' plain versions.

Per block, owner level, region id, shifts, bpp and endpoints must equal the
fixture's outside *flip segments*. torch and XLA add floats in other
orders: the port sums a region's P pixels in one halving tree, the JAX
kernel in 256-pixel chunks and then across chunks, and the four child costs
of the RD cut in XLA's order. So a rounded endpoint of a region at any
level can move by 1, which moves that region's bits and distortion, and
with them an RD keep decision, a neighbour match, or a run's acceptance.
The JAX finish also refits each run inside one jitted graph, whose fused
float order is neither its own eager order nor the port's: on
``small_rgba_l2`` (and its 3- and 4-level cases) JAX's eager
``coalesce_segments`` on the recorded state accepts the 2x3-block run at
block 868 and counts 106 runs, as the port does, while its jitted
``fused_rd_finish`` rejects it and counts 105. A flip segment is a
top-level quadtree square holding a region (at any level) whose fit
differs from JAX's jnp fit, a block whose owner level, run membership or
segment differs, or a run accepted on one side and rejected on the other
(at most 2% of the runs, plus one), each grown by the runs (the port's or
JAX's) through it. Flipped blocks are counted and bounded (at most 1% of
the blocks); PSNR must agree within 0.02 dB, mean bpp within 0.01, the bits
histogram within 0.5% of pixels plus what flipped blocks can move, the
per-level kept counts exactly outside flips, ``n_runs`` and
``rejected_runs`` within 2% plus one, and the RD cut's summed cost saving
within 0.1% (a float32 sum over hundreds of regions). On the two tiny
images (the 48x64 smoke image, the 70x90 edge-padded band image) nothing
flips, and every plane is equal.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu import regions as jregions
from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops import layout as jlayout
from limg_tpu.ops.fit import fit_blocks as j_fit

import limg_tpu_torch
from limg_tpu_torch import regions
from limg_tpu_torch.config import EncodeConfig, static_block_bits
from limg_tpu_torch.encoder import _packed_blocks
from limg_tpu_torch.kernels import encode_fixed as kmod
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS, fit_blocks
from tools import record_torch_merged_reference as mrec
from tools import record_torch_rd_reference as rec

torch.set_num_threads(1)

PSNR_DB, BPP, HIST_L1_FRAC, RUNS_FRAC = 0.02, 0.01, 0.005, 0.02
MAX_FLIP_FRAC = 0.01      # flipped blocks of either kind, of all blocks
COST_SAVED_RTOL = 1e-3
LAM = rec.RD_LAMBDA


@pytest.fixture(scope="module")
def fixture():
    fx = np.load(rec.OUT)
    return fx, json.loads(str(fx["meta"]))


def _case(name):
    make, levels, over, cap_frac, hdr, full_planes = rec.SMALL_CASES[name]
    return make(), levels, EncodeConfig(**mrec.config_kwargs(over)), cap_frac, hdr, full_planes


# ---------------------------------------------------------------------------
# The cut, the owner map and the relayout against the JAX package's
# ---------------------------------------------------------------------------

def _cost_rows(rng, grids, integer: bool):
    """Per-level bits (int32) and dist (float32) rows. Integer distortions
    make the child sums exact, so ties are decided by ``<=`` alone; random
    ones leave no parent within a rounding of its children's sum."""
    levels = []
    for lvl, g in enumerate(grids):
        n = g.num_blocks
        bits = rng.integers(110 + 64 * 4 ** lvl, 110 + 24 * 64 * 4 ** lvl, n).astype(np.int32)
        if integer:
            dist = (rng.integers(0, 400, n) * 100 * 4 ** lvl).astype(np.float32)
        else:
            dist = (rng.random(n) * 40000 * 4 ** lvl).astype(np.float32)
        levels.append(dict(bits=bits, dist=dist))
    return levels


@pytest.mark.parametrize("extra", [0.0, -46.0])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("num_levels", [2, 3, 4])
def test_rd_merge_keep_matches_jax(num_levels, integer, extra):
    rng = np.random.default_rng(num_levels * 10 + integer)
    h, w = 37 * 8 + 3, 53 * 8           # odd block grids at every level
    grids_t = [layout.grid_for(h, w, 8 << lvl) for lvl in range(num_levels)]
    grids_j = [jlayout.grid_for(h, w, 8 << lvl) for lvl in range(num_levels)]
    rows = _cost_rows(rng, grids_t, integer)
    lam = 0.01 if not integer else 0.5
    keep_t, st_t = limg_tpu_torch.rd_merge_keep(
        [{k: torch.from_numpy(v) for k, v in r.items()} for r in rows], grids_t, num_levels,
        lam, extra)
    keep_j, st_j = jregions.rd_merge_keep(
        [{k: jnp.asarray(v) for k, v in r.items()} for r in rows], grids_j, num_levels,
        jnp.float32(lam), extra)
    for lvl in range(num_levels):
        kt = keep_t[lvl].numpy()
        np.testing.assert_array_equal(kt, np.asarray(keep_j[lvl]))
        assert 0 < kt.sum() < kt.size or lvl == 0
    for s_t, s_j in zip(st_t, st_j):
        assert int(s_t["kept"]) == int(s_j["kept"])
        assert int(s_t["cost_reject"]) == int(s_j["cost_reject"])
        assert float(s_t["rd_cost_saved"]) == pytest.approx(float(s_j["rd_cost_saved"]),
                                                            rel=COST_SAVED_RTOL)


@pytest.mark.parametrize("num_levels", [2, 3, 4])
def test_owner_level_and_leaders_match_jax(num_levels):
    rng = np.random.default_rng(num_levels)
    h, w = 301, 437
    grids_t = [layout.grid_for(h, w, 8 << lvl) for lvl in range(num_levels)]
    grids_j = [jlayout.grid_for(h, w, 8 << lvl) for lvl in range(num_levels)]
    keep = [np.ones(grids_t[0].num_blocks, bool)] + [
        rng.random(g.num_blocks) < 0.4 for g in grids_t[1:]]
    own_t = regions._owner_level([torch.from_numpy(k) for k in keep], grids_t, num_levels)
    own_j = jregions._owner_level([jnp.asarray(k) for k in keep], grids_j, num_levels)
    np.testing.assert_array_equal(own_t.numpy(), np.asarray(own_j))
    for lvl in range(1, num_levels):
        gy, gx = grids_t[lvl - 1].blocks_y, grids_t[lvl - 1].blocks_x
        idx_t, valid_t = regions._child_indices(gy, gx, "cpu")
        idx_j, valid_j = jregions._child_indices(gy, gx)
        np.testing.assert_array_equal(idx_t.numpy(), idx_j)
        np.testing.assert_array_equal(valid_t.numpy(), valid_j)


@pytest.mark.parametrize("lvl", [1, 2, 3])
def test_q_level_to_block0_matches_jax(lvl):
    rng = np.random.default_rng(lvl)
    h, w = 301, 437
    grid_l, grid0 = layout.grid_for(h, w, 8 << lvl), layout.grid_for(h, w)
    q = rng.integers(-2**31, 2**31, (64 * 4 ** lvl, grid_l.num_blocks)).astype(np.int32)
    got = regions._q_level_to_block0(torch.from_numpy(q), grid_l, grid0, lvl)
    want = jregions._q_level_to_block0(jnp.asarray(q), jlayout.grid_for(h, w, 8 << lvl),
                                       jlayout.grid_for(h, w), lvl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("channels", [3, 4])
def test_rd_level0_equals_the_fixed_grid_encode(channels):
    """Level 0 of the RD policy draws the fixed grid's dither key: with
    dithering on, its encode equals ``encode_blocks_kernel`` on the fixed
    grid's blocks; level 1 draws other bits."""
    img = torch.from_numpy(mrec.make_4k_lane(72, 104, "rgba" if channels == 4 else "rgb"))
    cfg = EncodeConfig(error_factor=100, has_alpha=channels == 4, dithering=True)
    words = regions._words(img)
    lv0 = regions._encode_level(words, 0, cfg, 9)
    packed, mask, _ = _packed_blocks(img)
    shifts, q, dec, dist, *eps_avg = kmod.encode_blocks_kernel(packed, mask, cfg, 9,
                                                              emit_endpoints=True)
    for got, want in ((lv0["shifts"], shifts), (lv0["q"], q), (lv0["dec"], dec),
                      (lv0["dist"], dist[0]), (lv0["eps"], torch.stack(eps_avg[:6])),
                      (lv0["avg"], eps_avg[6])):
        assert torch.equal(got, want)
    lv1 = regions._encode_level(words, 1, cfg, 9)
    plain1 = regions._encode_level(words, 1, dataclasses.replace(cfg, dithering=False), 9)
    assert not torch.equal(lv1["q"], plain1["q"])     # dithered at level 1 too


# ---------------------------------------------------------------------------
# The whole slice against the fixture
# ---------------------------------------------------------------------------

def _fit_flip_squares(img, ch, levels):
    """(NB,) bool: level-0 blocks in a top-level square that holds a region,
    at any level, whose fit differs from JAX's jnp fit (float order)."""
    h, w = img.shape[:2]
    by, bx = -(-h // 8), -(-w // 8)
    top = 1 << (levels - 1)
    out = np.zeros((by, bx), bool)
    for lvl in range(levels):
        px, mask, g = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)), 8 << lvl)
        d_t = fit_blocks(px, mask, ch)
        d_j = j_fit(jnp.asarray(px.numpy()), jnp.asarray(mask.numpy()), ch)
        diff = np.zeros(g.num_blocks, bool)
        for f in ENDPOINT_FIELDS:
            diff |= (getattr(d_t, f).numpy() != np.asarray(getattr(d_j, f))).any(axis=0)
        for i in np.nonzero(diff)[0]:
            y, x = divmod(int(i), g.blocks_x)
            y0, x0 = ((y << lvl) // top) * top, ((x << lvl) // top) * top
            out[y0:y0 + top, x0:x0 + top] = True
    return out.reshape(-1)


def _flip_blocks(out, ref, state, img, ch, levels):
    """(blocks whose structure differs, blocks whose pixels alone differ,
    blocks in flip segments, each (NB,) bool; runs whose acceptance flips)."""
    own_t = mrec.per_block(out["owner_px"]).astype(np.int64)
    own_j = ref("owner").astype(np.int64)
    ep_diff = np.abs(out["endpoint_rows"].astype(np.int64)
                     - ref("endpoint_rows").astype(np.int64)).max(axis=0)
    mism = ((own_t != own_j) | (ep_diff > 0)
            | (mrec.per_block(out["shift"]) != ref("shifts")).any(axis=0)
            | (mrec.per_block(out["bpp"]) != ref("bpp"))
            | (mrec.per_block(out["region_id"]) != ref("region_id")))
    pixels = ~mism & ((mrec.block_hashes(out["factors"]) != ref("factors_hash"))
                      | (mrec.block_hashes(out["decoded"]) != ref("decoded_hash")))
    seg_t, run_t = state["seg0"].numpy(), state["is_run0"].numpy()
    seg_j, run_j = ref("seg0"), ref("is_run0").astype(bool)
    nb = own_t.size
    # one run, accepted on one side only: its members' region ids differ
    accept_flip = (run_t & run_j & (seg_t == seg_j)
                   & (mrec.per_block(out["region_id"]) % nb != ref("region_id") % nb))
    seed = ((own_t != own_j) | (seg_t != seg_j) | (run_t != run_j) | accept_flip
            | _fit_flip_squares(img, ch, levels))
    grown = (seed
             | (run_t & np.isin(seg_t, seg_t[seed & run_t]))
             | (run_j & np.isin(seg_j, seg_j[seed & run_j])))
    return mism, pixels, grown, len(np.unique(seg_t[accept_flip]))


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_port_matches_jax_rd_fixture(fixture, name):
    fx, meta = fixture
    img, levels, cfg, cap_frac, hdr, full_planes = _case(name)
    case = meta["cases"][name]
    assert (case["levels"], case["cap_frac"], case["rd_header_bits"]) == (levels, cap_frac, hdr)
    assert case["config"] == mrec.config_kwargs(rec.SMALL_CASES[name][2])

    def ref(key):
        return fx[f"{name}.{key}"]

    out = limg_tpu_torch.encode_image_merged(img, cfg, seed=0, num_levels=levels,
                                             merge_policy="rd", rd_lambda=LAM,
                                             cap_frac=cap_frac, rd_header_bits=hdr,
                                             device="cpu")
    state = limg_tpu_torch.fused_rd_pre(img, cfg, 0, LAM, levels, need_q=False,
                                        header_bits=hdr, device="cpu")
    n_px, nb = img.shape[0] * img.shape[1], ref("owner").size
    mism, pixels, flip, accept_flips = _flip_blocks(out, ref, state, img, cfg.channels, levels)
    hist_l1 = int(np.abs(out["bits_histogram"] - ref("bits_histogram")).sum())
    stats = [out["coalesce_stats"][k] for k in rec.STAT_KEYS]
    merge = np.asarray([[s[k] for k in rec.RD_KEYS] for s in out["merge_stats"]])
    print(f"{name}: psnr {out['psnr']:.5f} vs {float(ref('psnr')):.5f}, bpp "
          f"{out['mean_bpp']:.5f} vs {float(ref('mean_bpp')):.5f}, runs {out['n_runs']} vs "
          f"{int(ref('n_runs'))}, stats {stats} vs {ref('coalesce_stats').tolist()}, merge "
          f"{merge.tolist()} vs {ref('merge_stats').tolist()}, hist L1 {hist_l1}, "
          f"{int(mism.sum())} blocks differ in flip segments of {int(flip.sum())} blocks, "
          f"{int(pixels.sum())} in pixels alone, of {nb}; {accept_flips} acceptance flips")
    assert not (mism & ~flip).any(), np.nonzero(mism & ~flip)[0][:10]
    assert accept_flips <= RUNS_FRAC * int(ref("n_runs")) + 1
    assert mism.sum() + pixels.sum() <= MAX_FLIP_FRAC * nb
    assert abs(out["psnr"] - float(ref("psnr"))) <= PSNR_DB
    assert abs(out["mean_bpp"] - float(ref("mean_bpp"))) <= BPP
    # a flipped pixel moves one count per axis: at most 6 in L1
    assert hist_l1 <= HIST_L1_FRAC * n_px + 6 * 64 * int(mism.sum())
    own_flip = (mrec.per_block(out["owner_px"]) != ref("owner")).any()
    if not own_flip:
        np.testing.assert_array_equal(out["alive_counts"], ref("alive_counts"))
        np.testing.assert_array_equal(merge[:, [0, 2]], ref("merge_stats")[:, [0, 2]])
    np.testing.assert_allclose(merge[:, 1], ref("merge_stats")[:, 1], rtol=COST_SAVED_RTOL)
    n_runs_j, rejected_j = int(ref("n_runs")), int(ref("coalesce_stats")[2])
    assert abs(out["n_runs"] - n_runs_j) <= RUNS_FRAC * n_runs_j + (1 if flip.any() else 0)
    assert abs(stats[2] - rejected_j) <= RUNS_FRAC * rejected_j + (1 if flip.any() else 0)
    assert stats[0] == int(ref("coalesce_stats")[0])
    flipped_runs = int(state["n_run_blocks"]) - int(ref("n_run_blocks"))
    assert stats[1] - int(ref("coalesce_stats")[1]) == (flipped_runs if stats[1] else 0)
    if full_planes:
        assert not (mism | pixels | flip).any() and out["n_runs"] == n_runs_j
        assert stats == ref("coalesce_stats").tolist()
        np.testing.assert_array_equal(state["seg0"].numpy(), ref("seg0"))
        np.testing.assert_array_equal(out["decoded"], ref("decoded"))
        np.testing.assert_array_equal(out["factors"], ref("factors"))


def test_4k_rd_fixture_is_complete(fixture):
    """The 4K cases chip_smoke.py holds the card against."""
    fx, meta = fixture
    for lane in ("rgb", "rgba"):
        name = f"4k_{lane}_l3"
        assert meta["cases"][name]["cap_frac"] == 0 and meta["cases"][name]["levels"] == 3
        assert fx[f"{name}.owner"].shape == fx[f"{name}.is_run0"].shape == (270 * 480,)
        assert fx[f"{name}.bits_histogram"].sum(axis=1).tolist() == [2160 * 3840] * 3
        assert fx[f"{name}.coalesce_stats"][:2].tolist() == [0, 0]
        assert fx[f"{name}.merge_stats"].shape == (2, 3)
        assert int(fx[f"{name}.n_runs"]) > 500
        # JAX's dither effect on its dense RD encode of the lane
        for tag, dithering in (("_dense", False), ("_dither_dense", True)):
            case = meta["cases"][name + tag]
            assert case["config"]["dithering"] == dithering and case["levels"] == 3
            assert np.isfinite(float(fx[f"{name}{tag}.psnr"]))
        assert float(fx[f"{name}_dither_dense.psnr"]) < float(fx[f"{name}_dense.psnr"]) - 1
    assert abs(float(fx["4k_rgb_l3.psnr"]) - 39.18222) < 1e-4
    np.testing.assert_array_equal(fx["4k_rgb_l3.alive_counts"], [129600, 26968, 1511])


# ---------------------------------------------------------------------------
# Entry points, and one live JAX run
# ---------------------------------------------------------------------------

def test_live_jax_dense_rd_encode_agrees():
    """JAX's dense RD path (``use_pallas=False``, its jnp encode of every
    level and per-level band coalescing) run now on the smoke image,
    against the port's fused RD encode."""
    img = mrec.smoke_image()
    j = jregions.encode_image_merged(img, JConfig(error_factor=100, dithering=False), seed=0,
                                     num_levels=2, use_pallas=False, merge_policy="rd",
                                     rd_lambda=LAM)
    t = limg_tpu_torch.encode_image_merged(img, EncodeConfig(error_factor=100, dithering=False),
                                           num_levels=2, merge_policy="rd", rd_lambda=LAM,
                                           device="cpu")
    assert abs(t["psnr"] - j["psnr"]) <= PSNR_DB
    assert abs(t["mean_bpp"] - j["mean_bpp"]) <= BPP
    np.testing.assert_array_equal(t["alive_counts"], np.asarray(j["alive_counts"]))


def test_split_rd_stages_equal_the_one_call_encode():
    img = mrec.make_4k_lane(64, 96, "rgba")
    cfg = EncodeConfig(has_alpha=True, dithering=True)
    state = limg_tpu_torch.fused_rd_pre(img, cfg, 5, 0.02, 3, header_bits=80, device="cpu")
    split = limg_tpu_torch.fused_rd_finish(state, cfg, 5, 0.02, 3, True, cap=96,
                                           header_bits=80)
    one = limg_tpu_torch.encode_image_merged_rd_device(img, cfg, seed=5, rd_lambda=0.02,
                                                       num_levels=3, cap_frac=1,
                                                       header_bits=80, device="cpu")
    assert set(split) == set(one)
    for key, v in one.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(split[key], v), key
    assert int(one["n_runs"]) > 0 and (one["decoded"][..., 3] != 255).any()
    with pytest.raises(ValueError, match="need_q"):
        limg_tpu_torch.fused_rd_finish(
            limg_tpu_torch.fused_rd_pre(img, cfg, 5, 0.02, 3, need_q=False, device="cpu"),
            cfg, 5, 0.02, 3, True, cap=96)


@pytest.mark.parametrize("num_levels", [2, 3, 4])
def test_rd_header_bits_and_lambda_steer_the_cut(num_levels):
    """A cheaper region header keeps fewer merged regions (each split
    region pays less); another lambda weighs distortion otherwise and moves
    the cut; level 0 counts every block."""
    img = mrec.make_4k_lane(128, 192, "rgb")
    cfg = EncodeConfig(dithering=False)

    def alive(**kw):
        out = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=num_levels,
                                                 merge_policy="rd", fetch_planes=False,
                                                 device="cpu", **kw)
        return out["alive_counts"]

    base = alive()
    assert base[0] == 16 * 24 and len(base) == num_levels
    assert alive(rd_header_bits=static_block_bits(3) - 60)[1] <= base[1]
    assert (alive(rd_lambda=1.0) != base).any()


def test_rd_policy_without_coalescing():
    """``coalesce=False`` leaves every block in its owner region."""
    img = mrec.make_4k_lane(64, 96, "rgb")
    out = limg_tpu_torch.encode_image_merged(img, EncodeConfig(dithering=False), num_levels=3,
                                             merge_policy="rd", coalesce=False, device="cpu")
    assert out["n_runs"] == 0 and out["coalesce_stats"] == {}
    own = mrec.per_block(out["owner_px"])
    rid = mrec.per_block(out["region_id"])
    assert (rid // own.size == own).all()
    with pytest.raises(ValueError, match="merge_policy"):
        limg_tpu_torch.encode_image_merged(img, EncodeConfig(), merge_policy="greedy",
                                           device="cpu")
