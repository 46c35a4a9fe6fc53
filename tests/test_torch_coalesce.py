"""limg_tpu_torch's run building and run coalescing (the default merged
encode) vs the JAX package, on the CPU.

tests/fixtures/torch_port_coalesce_reference.npz holds the public output of
``limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True,
coalesce=True)`` and the run building of ``fused_merged_pre``
(tools/record_torch_coalesce_reference.py; dithering off). On the CPU the
port runs its kernels' plain versions.

Per block, owner level, region id, shifts, bpp and endpoints must equal the
fixture's outside *flip segments*: torch and XLA add floats in other
orders, so a rounded endpoint can move by 1, and a merge or match decision
that depends on it can go the other way. A flip segment is a run (the
port's or JAX's) holding a block whose owner level, run membership or
segment differs, or whose level-0 fit or endpoints differ from JAX's by 1,
or a quadtree square holding a level-0 flip. A block whose structure
agrees may still differ in a pixel's factor: a factor one rounding step
from a crush bucket's edge (a refit's factors are extracted in JAX's
jitted graph, in another float order). Both kinds of flipped block are
counted and bounded; PSNR must agree within 0.02 dB, mean bpp within 0.01,
the bits histogram within 0.5% of pixels (plus what flipped blocks can
move), ``n_runs`` and ``rejected_runs`` within 2% (equal on the smoke
image), the dropped count exactly and the overflow count up to the
flipped run blocks.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops import layout as jlayout
from limg_tpu.ops.fit import Decomposition as JDecomp
from limg_tpu.ops.match import match_decomps as j_match
from limg_tpu import regions as jregions

import limg_tpu_torch
from limg_tpu_torch import regions
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import coalesce as kc
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.match import _MAX_FACTOR_SUM, probe_deviation_mean
from chip_smoke import seeded_rows
from tests.test_torch_merged import _jax_level0_diff
from tools import record_torch_coalesce_reference as rec
from tools import record_torch_merged_reference as mrec

torch.set_num_threads(1)

PSNR_DB, BPP, HIST_L1_FRAC, RUNS_FRAC = 0.02, 0.01, 0.005, 0.02
MAX_FLIP_FRAC = 0.01      # flipped blocks of either kind, of all blocks
STAT_KEYS = rec.STAT_KEYS


@pytest.fixture(scope="module")
def fixture():
    fx = np.load(rec.OUT)
    return fx, json.loads(str(fx["meta"]))


def _case(name):
    make, levels, over, cap_frac, full_planes = rec.SMALL_CASES[name]
    return make(), levels, EncodeConfig(**mrec.config_kwargs(over)), cap_frac, full_planes


# ---------------------------------------------------------------------------
# The match kernels' plain versions and neighbour routing
# ---------------------------------------------------------------------------

def _near_threshold(a, b, ch):
    """Pairs whose probe mean lies within 1e-5 of 3.0 (where XLA's sum
    order may decide the other way)."""
    da, db = kc._as_decomp(torch.from_numpy(a), ch), kc._as_decomp(torch.from_numpy(b), ch)
    return np.abs(probe_deviation_mean(da, db, ch)[0].numpy() - _MAX_FACTOR_SUM) < 1e-5


@pytest.mark.parametrize("channels", [3, 4])
def test_match_pairs_matches_jax(channels):
    rng = np.random.default_rng(40 + channels)
    a = seeded_rows(rng, 3000, channels)
    b = a + (rng.random(a.shape) < 0.3) * rng.integers(0, 6, a.shape).astype(np.float32)
    b[:, ::2] = seeded_rows(rng, 1500, channels)            # unrelated pairs too
    got = kc.match_pairs_kernel(torch.from_numpy(a), torch.from_numpy(b), channels).numpy()
    split = lambda r: JDecomp(*(jnp.asarray(r[channels * i:channels * (i + 1)]) for i in range(7)))
    want = np.asarray(j_match(split(a), split(b), channels)[0])
    diff = got != want
    assert not (diff & ~_near_threshold(a, b, channels)).any()
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("gy,gx", [(19, 210), (1, 37), (23, 1), (130, 130)])
def test_neighbor_pair_matches_matches_jax(gy, gx):
    """Both routes (the neighbour plane at >= 16384 blocks, paired stacks
    below) against JAX's neighbor_pair_matches, one-row and one-column
    grids included."""
    ch = 3
    rng = np.random.default_rng(gy * 1000 + gx)
    rows = seeded_rows(rng, gy * gx, ch)
    grid_t, grid_j = layout.BlockGrid(gy * 8, gx * 8, gy, gx), jlayout.grid_for(gy * 8, gx * 8)
    (got,) = regions.neighbor_pair_matches([torch.from_numpy(rows)], [grid_t], ch)
    (want,) = jregions.neighbor_pair_matches([jnp.asarray(rows)], [grid_j], ch)
    plane = rows.reshape(7 * ch, gy, gx)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if k == 0:
            a, b = plane[:, :, 1:], plane[:, :, :-1]
        else:
            a, b = plane[:, 1:], plane[:, :-1]
        near = _near_threshold(a.reshape(7 * ch, -1), b.reshape(7 * ch, -1), ch).reshape(g.shape)
        assert not ((g != w) & ~near).any()
    m_right, m_down = kc.match_neighbors_kernel(torch.from_numpy(plane), ch)
    assert not m_right[:, -1].any() and not m_down[-1].any()
    one = torch.from_numpy(rows[:, :1])
    assert regions.neighbor_pair_matches([one], [layout.BlockGrid(8, 8, 1, 1)], ch) == [(None, None)]


@pytest.mark.parametrize("max_members", [256, 64, 16])
def test_build_runs_matches_jax(max_members):
    """Run building is integer logic: bit-equal to JAX's build_runs on the
    same owned map and matches."""
    rng = np.random.default_rng(max_members)
    gy, gx = 37, 300
    owned = rng.random(gy * gx) < 0.8
    m_left = rng.random((gy, gx - 1)) < 0.85
    m_up = rng.random((gy - 1, gx)) < 0.85
    m_up[:, :40] = True                     # stacked equal spans: rectangles
    m_left[:12, :40] = True
    grid_t = layout.BlockGrid(gy * 8, gx * 8, gy, gx)
    seg_t, len_t = regions.build_runs(torch.from_numpy(owned), grid_t, max_members,
                                      (torch.from_numpy(m_left), torch.from_numpy(m_up)))
    seg_j, len_j = jregions.build_runs(None, jnp.asarray(owned), jlayout.grid_for(gy * 8, gx * 8),
                                       3, max_members=max_members,
                                       matches=(jnp.asarray(m_left), jnp.asarray(m_up)))
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert len_t.max() <= max_members and len_t.max() >= 2


def test_capacity_rules_match_jax():
    for nb in (100, 4096, 4097, 129600):
        for cap_frac in (-300, -1, 0, 1, 8, 4):
            assert regions._coalesce_cap(cap_frac, nb) == jregions._coalesce_cap(cap_frac, nb)
        for n_run in (0, 1, 4095, 4097, 94047, 129600):
            assert regions.auto_run_capacity(n_run, nb) == jregions.auto_run_capacity(n_run, nb)
    assert limg_tpu_torch.auto_run_capacity(94047, 129600) == 129600


# ---------------------------------------------------------------------------
# Run building and the whole slice against the fixture
# ---------------------------------------------------------------------------

def _level0_flip_squares(name, img, ch, levels):
    """(by, bx) bool: blocks in a top-level square holding a level-0 block
    whose fit differs from JAX's by 1."""
    h, w = img.shape[:2]
    by, bx = -(-h // 8), -(-w // 8)
    flip = _jax_level0_diff(name, img, ch).reshape(by, bx) == 1
    g = 1 << (levels - 1)
    out = np.zeros_like(flip)
    for y, x in zip(*np.nonzero(flip)):
        y0, x0 = (y // g) * g, (x // g) * g
        out[y0:y0 + g, x0:x0 + g] = True
    return out.reshape(-1)


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_run_building_matches_fixture(fixture, name):
    fx, meta = fixture
    img, levels, cfg, _, _ = _case(name)
    assert meta["cases"][name]["levels"] == levels
    state = limg_tpu_torch.fused_merged_pre(img, cfg, num_levels=levels, device="cpu")
    seg_t, run_t = state["seg0"].numpy(), state["is_run0"].numpy()
    seg_j, run_j = fx[f"{name}.seg0"], fx[f"{name}.is_run0"].astype(bool)
    mism = (seg_t != seg_j) | (run_t != run_j)
    flips = _level0_flip_squares(name, img, cfg.channels, levels)
    print(f"{name}: run blocks {int(state['n_run_blocks'])} vs {int(fx[f'{name}.n_run_blocks'])}, "
          f"{int(mism.sum())} blocks differ, level-0 flip squares {int(flips.sum())} blocks")
    if not flips.any():
        assert not mism.any()
        assert int(state["n_run_blocks"]) == int(fx[f"{name}.n_run_blocks"])
    assert mism.sum() <= MAX_FLIP_FRAC * seg_t.size


def _flip_blocks(out, ref, state, name, img, ch, levels):
    """(blocks whose structure differs, blocks whose pixels alone differ,
    blocks in flip segments), each (NB,) bool."""
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
    seed = ((own_t != own_j) | (seg_t != seg_j) | (run_t != run_j) | (ep_diff == 1)
            | _level0_flip_squares(name, img, ch, levels))
    grown = (seed
             | (run_t & np.isin(seg_t, seg_t[seed & run_t]))
             | (run_j & np.isin(seg_j, seg_j[seed & run_j])))
    return mism, pixels, grown


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_port_matches_jax_coalesce_fixture(fixture, name):
    fx, meta = fixture
    img, levels, cfg, cap_frac, full_planes = _case(name)
    assert meta["cases"][name]["config"] == mrec.config_kwargs(rec.SMALL_CASES[name][2])

    def ref(key):
        return fx[f"{name}.{key}"]

    out = limg_tpu_torch.encode_image_merged(img, cfg, seed=0, num_levels=levels,
                                             cap_frac=cap_frac, device="cpu")
    state = limg_tpu_torch.fused_merged_pre(img, cfg, num_levels=levels, need_q=False,
                                            device="cpu")
    n_px, nb = img.shape[0] * img.shape[1], ref("owner").size
    mism, pixels, flip = _flip_blocks(out, ref, state, name, img, cfg.channels, levels)
    hist_l1 = int(np.abs(out["bits_histogram"] - ref("bits_histogram")).sum())
    stats = [out["coalesce_stats"][k] for k in STAT_KEYS]
    print(f"{name}: psnr {out['psnr']:.5f} vs {float(ref('psnr')):.5f}, bpp "
          f"{out['mean_bpp']:.5f} vs {float(ref('mean_bpp')):.5f}, runs {out['n_runs']} vs "
          f"{int(ref('n_runs'))}, stats {stats} vs {ref('coalesce_stats').tolist()}, hist L1 "
          f"{hist_l1}, {int(mism.sum())} blocks differ in flip segments of {int(flip.sum())} "
          f"blocks, {int(pixels.sum())} in pixels alone, of {nb}")
    assert not (mism & ~flip).any(), np.nonzero(mism & ~flip)[0][:10]
    assert mism.sum() + pixels.sum() <= MAX_FLIP_FRAC * nb
    assert abs(out["psnr"] - float(ref("psnr"))) <= PSNR_DB
    assert abs(out["mean_bpp"] - float(ref("mean_bpp"))) <= BPP
    # a flipped pixel moves one count per axis: at most 6 in L1
    assert hist_l1 <= HIST_L1_FRAC * n_px + 6 * 64 * int(mism.sum())
    n_runs_j, rejected_j = int(ref("n_runs")), int(ref("coalesce_stats")[2])
    assert abs(out["n_runs"] - n_runs_j) <= RUNS_FRAC * n_runs_j + (0 if not flip.any() else 1)
    assert abs(stats[2] - rejected_j) <= RUNS_FRAC * rejected_j + (0 if not flip.any() else 1)
    # the overflow is the run blocks past the capacity: flipped run blocks
    # move it one for one
    assert stats[0] == int(ref("coalesce_stats")[0])
    flipped_runs = int(state["n_run_blocks"]) - int(ref("n_run_blocks"))
    assert stats[1] - int(ref("coalesce_stats")[1]) == (flipped_runs if stats[1] else 0)
    if full_planes:
        assert not (mism | pixels).any() and out["n_runs"] == n_runs_j
        assert stats == ref("coalesce_stats").tolist()
        np.testing.assert_array_equal(out["decoded"], ref("decoded"))
        np.testing.assert_array_equal(out["factors"], ref("factors"))


def test_truncation_counts_the_split_segment(fixture):
    """A pinned capacity below the run count cuts the sorted buffer: the one
    split segment reverts and is counted as dropped, not rejected; auto
    capacity drops nothing."""
    fx, _ = fixture
    img, levels, cfg, _, _ = _case("small_rgb_l3_cap300")
    tiny = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels, cap_frac=-300,
                                              fetch_planes=False, device="cpu")
    auto = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels, fetch_planes=False,
                                              device="cpu")
    n_run = int(fx["small_rgb_l3_cap300.n_run_blocks"])
    st = tiny["coalesce_stats"]
    assert st["dropped_runs_at_capacity"] == 1
    assert abs(st["overflow_run_blocks"] - (n_run - 300)) <= RUNS_FRAC * n_run
    assert auto["coalesce_stats"]["dropped_runs_at_capacity"] == 0
    assert auto["coalesce_stats"]["overflow_run_blocks"] == 0
    assert tiny["n_runs"] < auto["n_runs"]


def test_4k_fixture_is_complete(fixture):
    """The 4K cases chip_smoke.py holds the card against."""
    fx, meta = fixture
    for lane in ("rgb", "rgba"):
        name = f"4k_{lane}_l3"
        assert meta["cases"][name]["cap_frac"] == 0
        assert fx[f"{name}.owner"].shape == fx[f"{name}.is_run0"].shape == (270 * 480,)
        assert fx[f"{name}.bits_histogram"].sum(axis=1).tolist() == [2160 * 3840] * 3
        assert fx[f"{name}.coalesce_stats"][:2].tolist() == [0, 0]
        assert int(fx[f"{name}.n_runs"]) > 1000
    assert abs(float(fx["4k_rgb_l3.psnr"]) - 39.22688) < 1e-4
    assert int(fx["4k_rgb_l3.n_runs"]) == 10391


# ---------------------------------------------------------------------------
# The smoke image's pins, and one live JAX run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_out():
    cfg = EncodeConfig(error_factor=100, crush_mode="ladder", dithering=False)
    return limg_tpu_torch.encode_image_merged(mrec.smoke_image(), cfg, num_levels=2,
                                              device="cpu")


def test_smoke_pins_of_the_jax_package(smoke_out):
    """tests/test_merged_smoke.py's pinned expectations, on the port."""
    out, src = smoke_out, mrec.smoke_image()
    assert out["psnr"] == pytest.approx(43.905, abs=0.3)
    assert out["mean_bpp"] == pytest.approx(5.0, abs=0.15)
    assert int(out["alive_counts"][1]) >= 4 and out["n_runs"] >= 3
    assert out["coalesce_stats"]["overflow_run_blocks"] == 0
    assert out["coalesce_stats"]["dropped_runs_at_capacity"] == 0
    assert {0, 1} <= set(np.unique(out["owner_px"]).tolist())
    assert out["factors"].shape == (48, 64, 3) and out["region_id"].shape == (48, 64)
    assert len(np.unique(out["region_id"][0, :])) == 1
    assert len(np.unique(out["region_id"][32, :])) == 1
    np.testing.assert_array_equal(out["decoded"][0:8, :, :3], src[0:8, :, :3])
    np.testing.assert_array_equal(out["decoded"][32:, :, :3], src[32:, :, :3])


def test_live_jax_coalesced_encode_agrees(smoke_out):
    """JAX's default fused encode run now (not the fixture) on the smoke
    image: every plane and stat equal."""
    j = jregions.encode_image_merged(mrec.smoke_image(), JConfig(error_factor=100, dithering=False),
                                     seed=0, num_levels=2, use_pallas=True, fused=True)
    t = smoke_out
    assert set(t) == set(j)
    for key in ("decoded", "factors", "shift", "bpp", "region_id", "owner_px", "endpoint_rows",
                "alive_counts", "bits_histogram"):
        np.testing.assert_array_equal(t[key], np.asarray(j[key]), err_msg=key)
    assert t["merge_stats"] == j["merge_stats"]
    assert t["n_runs"] == j["n_runs"] and t["coalesce_stats"] == j["coalesce_stats"]
    assert abs(t["psnr"] - j["psnr"]) < 1e-6 and abs(t["mean_bpp"] - j["mean_bpp"]) < 1e-6


def test_split_stages_equal_the_one_call_encode():
    img = mrec.make_4k_lane(64, 96, "rgba")
    cfg = EncodeConfig(has_alpha=True, dithering=True)
    state = limg_tpu_torch.fused_merged_pre(img, cfg, seed=5, num_levels=3, device="cpu")
    split = limg_tpu_torch.fused_merged_finish(state, cfg, 5, 3, True, cap=96)
    one = limg_tpu_torch.encode_image_merged_fused_device(img, cfg, seed=5, num_levels=3,
                                                          cap_frac=1, device="cpu")
    assert set(split) == set(one)
    for key, v in one.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(split[key], v), key
    assert {k: int(v) for k, v in split["coalesce_stats"].items()} == {
        k: int(v) for k, v in one["coalesce_stats"].items()}
    assert int(one["n_runs"]) > 0 and (one["decoded"][..., 3] != 255).any()
