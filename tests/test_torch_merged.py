"""limg_tpu_torch's quadtree-merged encode (coalescing off) vs the JAX
package's fused path, on the CPU.

tests/fixtures/torch_port_merged_reference.npz holds the public output of
``limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True,
coalesce=False)`` (tools/record_torch_merged_reference.py; the Pallas
kernels in interpret mode, dithering off). On the CPU the port runs the
plain versions of its two kernels.

Per block, owner level, shifts, endpoints, bpp, region id and the factor
and decoded pixels must equal the fixture's, except inside *flip regions*:
torch and XLA add floats in other orders, so a rounded endpoint can move by
1 (tests/test_jax_vs_golden.py:68-71), and a merge decision that depends on
it can go the other way. A mismatched block is explained when the square of
its larger owner level holds a block whose level-0 fit differs from the JAX
package's by exactly 1, or when the owners agree and its endpoints differ
by at most 1. The flips are counted and bounded; PSNR must agree within
0.02 dB, mean bpp within 0.01, and the bits histogram within 0.5% of pixels
plus what the flipped blocks can move (at 256x384 one flipped 16x16 region
alone is 0.26% of the pixels and can move the histogram by 1536).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops.fit import fit_blocks as j_fit
from limg_tpu.pallas_kernels.encode_merged import morton_mask as j_morton_mask
from limg_tpu.pallas_kernels.encode_merged import morton_perm as j_morton_perm
from limg_tpu.regions import encode_image_merged as j_encode_merged

import limg_tpu_torch
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import build
from limg_tpu_torch.kernels import encode_merged as km
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.crush import err_scale_shift
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS, fit_blocks
from limg_tpu_torch.ops.morton import MortonOrder, morton_mask, morton_perm
from limg_tpu_torch.ops.reduce import BlockReducer, GroupReducer, OwnerReducer
from tests.conftest import make_test_image
from tools import record_torch_merged_reference as rec

torch.set_num_threads(1)

PSNR_DB, BPP, HIST_L1_FRAC = 0.02, 0.01, 0.005
MAX_FLIP_FRAC = 0.01      # mismatched blocks, of all blocks
JAX_KEYS = {"decoded", "alive_counts", "bits_histogram", "psnr", "mse", "mean_bpp",
            "avg_block_bits", "merge_stats", "n_runs", "coalesce_stats"}
PLANE_KEYS = {"factors", "shift", "bpp", "region_id", "owner_px", "endpoint_rows"}


@pytest.fixture(scope="module")
def fixture():
    fx = np.load(rec.OUT)
    return fx, json.loads(str(fx["meta"]))


def _np_pairwise(x, group, op):
    """numpy pairwise-adjacent tree over aligned groups, broadcast back."""
    n = x.shape[-1]
    y = x.reshape(*x.shape[:-1], n // group, group)
    while y.shape[-1] > 1:
        y = op(y[..., 0::2], y[..., 1::2])
    return np.broadcast_to(y, (*x.shape[:-1], n // group, group)).reshape(x.shape)


# ---------------------------------------------------------------------------
# Morton order and the reducers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("by,bx,levels", [(9, 12, 3), (5, 6, 2), (34, 48, 4), (7, 3, 3)])
def test_morton_perm_and_mask_equal_jax(by, bx, levels):
    perm, byp, bxp = morton_perm(by, bx, levels)
    j_perm, j_byp, j_bxp = j_morton_perm(by, bx, levels)
    assert (byp, bxp) == (j_byp, j_bxp)
    np.testing.assert_array_equal(perm, j_perm)
    h, w = by * 8 - 3, bx * 8 - 5
    np.testing.assert_array_equal(morton_mask(h, w, levels).numpy(),
                                  np.asarray(j_morton_mask(h, w, levels)).astype(bool))
    order = MortonOrder(by, bx, levels, "cpu")
    rows = torch.arange(2 * by * bx, dtype=torch.int32).reshape(2, -1)
    emb = order.embed(rows)
    assert emb.shape == (2, byp * bxp)
    assert torch.equal(order.restore(emb), rows)
    assert (emb[:, torch.from_numpy(perm < 0)] == 0).all()


@pytest.mark.parametrize("group", [1, 4, 16, 64])
def test_group_reducer_is_a_pairwise_tree(group):
    rng = np.random.default_rng(group)
    x = rng.normal(0, 1e4, (3, 64, 256)).astype(np.float32)
    red = GroupReducer(group)
    rows = x.reshape(3, 8, 8, 256)              # (ch, pixel row, column, block)
    blk = rows[:, 0]
    for r in range(1, 8):                       # left fold over the rows ...
        blk = blk + rows[:, r]
    while blk.shape[1] > 1:                     # ... pairwise over the columns
        blk = blk[:, 0::2] + blk[:, 1::2]
    want = _np_pairwise(blk[:, 0], group, np.add)
    got = red.sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)    # bitwise: same order
    xi = rng.integers(-2**31, 2**31 - 1, (2, 256), dtype=np.int64).astype(np.int32)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(red.combine_sum(torch.from_numpy(xi)).numpy(),
                                      _np_pairwise(xi, group, np.add))
    np.testing.assert_array_equal(red.combine_max(torch.from_numpy(xi)).numpy(),
                                  _np_pairwise(xi, group, np.maximum))
    assert red.chunks == group


def test_owner_reducer_selects_each_blocks_level():
    rng = np.random.default_rng(3)
    levels, n = 3, 256
    x = rng.normal(0, 1e3, (n,)).astype(np.float32)
    owner = np.repeat(rng.integers(0, levels, n // 16), 16)      # constant per square
    owner[:16] = np.repeat([0, 1, 1, 0], 4)                       # mixed square
    red = OwnerReducer(torch.from_numpy(owner), levels)
    got = red.combine_sum(torch.from_numpy(x)).numpy()
    want = x.copy()
    for lvl in (1, 2):
        want = np.where(owner == lvl, _np_pairwise(x, 4 ** lvl, np.add), want)
    np.testing.assert_array_equal(got, want)
    assert red.chunks == 16
    assert torch.equal(BlockReducer().combine_sum(torch.from_numpy(x)), torch.from_numpy(x))


def test_err_scale_shift_rule():
    # regions of 64 * 4^(levels-1) pixels: only 4 levels pre-scale
    assert [err_scale_shift(64 * 4 ** (lv - 1)) for lv in (1, 2, 3, 4)] == [0, 0, 0, 4]


# ---------------------------------------------------------------------------
# The whole slice against the JAX fixture
# ---------------------------------------------------------------------------

_J_FIT_CACHE = {}


def _jax_level0_diff(name, img, ch):
    """(NB,) max |endpoint| difference of the port's level-0 fit vs JAX's."""
    if name not in _J_FIT_CACHE:
        px, mask, _ = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)))
        d_t = fit_blocks(px, mask, ch)
        d_j = j_fit(jnp.asarray(px.numpy()), jnp.asarray(mask.numpy()), ch)
        diff = np.zeros(px.shape[-1], np.int64)
        for f in ENDPOINT_FIELDS:
            a = getattr(d_t, f).numpy().astype(np.int64)
            diff = np.maximum(diff, np.abs(a - np.asarray(getattr(d_j, f))).max(axis=0))
        _J_FIT_CACHE[name] = diff
    return _J_FIT_CACHE[name]


def _flip_check(name, img, ch, levels, out, ref):
    """Mismatched blocks, all of them explained by flip regions."""
    h, w = img.shape[:2]
    by, bx = -(-h // 8), -(-w // 8)
    own_t = rec.per_block(out["owner_px"]).astype(np.int64)
    own_j = ref("owner").astype(np.int64)
    ep_t, ep_j = out["endpoint_rows"].astype(np.int64), ref("endpoint_rows").astype(np.int64)
    ep_diff = np.abs(ep_t - ep_j).max(axis=0)
    mism = ((own_t != own_j) | (ep_diff > 0)
            | (rec.per_block(out["shift"]) != ref("shifts")).any(axis=0)
            | (rec.per_block(out["bpp"]) != ref("bpp"))
            | (rec.per_block(out["region_id"]) != ref("region_id"))
            | (rec.block_hashes(out["factors"]) != ref("factors_hash"))
            | (rec.block_hashes(out["decoded"]) != ref("decoded_hash")))
    if not mism.any():
        return 0, 0
    lvl0 = _jax_level0_diff(name, img, ch).reshape(by, bx)
    squares = set()
    for b in np.nonzero(mism)[0]:
        y, x = divmod(int(b), bx)
        s = int(max(own_t[b], own_j[b]))
        y0, x0 = (y >> s) << s, (x >> s) << s
        level0_flip = (lvl0[y0:y0 + (1 << s), x0:x0 + (1 << s)] == 1).any()
        region_flip = own_t[b] == own_j[b] and ep_diff[b] <= 1
        assert level0_flip or region_flip, f"{name}: block {b} differs without a flip"
        squares.add((s, y0, x0))
    return int(mism.sum()), len(squares)


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_port_matches_jax_fused_fixture(fixture, name):
    fx, meta = fixture
    make, levels, over, full_planes = rec.SMALL_CASES[name]
    img = make()
    cfg = EncodeConfig(**rec.config_kwargs(over))
    assert meta["cases"][name]["levels"] == levels
    assert meta["cases"][name]["config"] == rec.config_kwargs(over)

    def ref(key):
        return fx[f"{name}.{key}"]

    out = limg_tpu_torch.encode_image_merged(img, cfg, seed=0, num_levels=levels,
                                             coalesce=False, device="cpu")
    n_px = img.shape[0] * img.shape[1]
    nb = ref("owner").size
    flips, regions = _flip_check(name, img, cfg.channels, levels, out, ref)
    hist_l1 = int(np.abs(out["bits_histogram"] - ref("bits_histogram")).sum())
    print(f"{name}: psnr {out['psnr']:.5f} vs {float(ref('psnr')):.5f}, bpp "
          f"{out['mean_bpp']:.5f} vs {float(ref('mean_bpp')):.5f}, hist L1 {hist_l1}, "
          f"flips {flips} blocks in {regions} regions of {nb}")
    assert flips <= MAX_FLIP_FRAC * nb
    assert abs(out["psnr"] - float(ref("psnr"))) <= PSNR_DB
    assert abs(out["mean_bpp"] - float(ref("mean_bpp"))) <= BPP
    # a flipped pixel moves one count per axis: at most 6 in L1
    assert hist_l1 <= HIST_L1_FRAC * n_px + 6 * 64 * flips
    # each flipped region moves a region count and a merge decision by one
    alive_diff = np.abs(out["alive_counts"] - ref("alive_counts"))
    merge = np.asarray([[s[k] for k in rec.MERGE_KEYS] for s in out["merge_stats"]])
    assert alive_diff.sum() <= regions
    assert np.abs(merge - ref("merge_stats")).sum() <= 2 * regions
    if full_planes:
        assert flips == 0
        np.testing.assert_array_equal(out["decoded"], ref("decoded"))
        np.testing.assert_array_equal(out["factors"], ref("factors"))


def test_output_dict_has_jax_keys_and_shapes():
    img = rec.make_4k_lane(64, 96, "rgba")
    out = limg_tpu_torch.encode_image_merged(img, EncodeConfig(has_alpha=True, dithering=False),
                                             coalesce=False, device="cpu")
    assert set(out) == JAX_KEYS | PLANE_KEYS
    assert out["decoded"].shape == (64, 96, 4) and out["decoded"].dtype == np.uint8
    assert out["factors"].shape == (64, 96, 3) and out["factors"].dtype == np.uint8
    assert out["shift"].shape == (3, 64, 96) and out["shift"].dtype == np.uint8
    assert out["bpp"].shape == out["owner_px"].shape == out["region_id"].shape == (64, 96)
    assert out["endpoint_rows"].shape == (24, 8 * 12)
    assert out["alive_counts"].shape == (3,) and out["bits_histogram"].shape == (3, 9)
    assert len(out["merge_stats"]) == 2 and set(out["merge_stats"][0]) == set(rec.MERGE_KEYS)
    assert out["n_runs"] == 0 and out["coalesce_stats"] == {}
    lean = limg_tpu_torch.encode_image_merged(img, EncodeConfig(has_alpha=True, dithering=False),
                                              coalesce=False, fetch_planes=False,
                                              fetch_decoded=False, device="cpu")
    assert set(lean) == JAX_KEYS and lean["decoded"] is None
    assert lean["psnr"] == out["psnr"] and lean["mean_bpp"] == out["mean_bpp"]


def test_device_entry_point_keeps_tensors_on_device():
    img = rec.make_4k_lane(40, 56, "rgb")
    out = limg_tpu_torch.encode_image_merged_fused_device(
        img, EncodeConfig(dithering=True), seed=3, num_levels=2, coalesce=False, device="cpu")
    assert out["decoded"].device.type == "cpu" and out["decoded"].shape == (40, 56, 4)
    assert out["factors_pnb"].shape == (3, 64, 35) and out["block_rows8"].shape == (5, 35)
    assert bool(torch.isfinite(out["total_err"])) and float(out["mean_bpp"]) > 0
    assert (out["decoded"][..., 3] == 255).all()


def test_live_jax_fused_path_agrees():
    """JAX's fused path run now (not the fixture) on a small textured image."""
    img = make_test_image(np.random.default_rng(17), 40, 48)[..., :3].copy()
    img[:16, :24] = [90, 150, 30]
    j = j_encode_merged(img, JConfig(error_factor=100, dithering=False), seed=0,
                        num_levels=2, use_pallas=True, fused=True, coalesce=False)
    t = limg_tpu_torch.encode_image_merged(img, EncodeConfig(error_factor=100, dithering=False),
                                           seed=0, num_levels=2, coalesce=False, device="cpu")
    assert set(t) == set(j)
    for key in PLANE_KEYS | {"decoded", "alive_counts", "bits_histogram"}:
        assert np.shape(t[key]) == np.shape(j[key]), key
        np.testing.assert_array_equal(t[key], np.asarray(j[key]), err_msg=key)
    assert t["merge_stats"] == j["merge_stats"]
    # JAX sums the stats in float32, the port in float64
    assert abs(t["psnr"] - j["psnr"]) < 1e-6 and abs(t["mean_bpp"] - j["mean_bpp"]) < 1e-6


def test_4k_fixture_is_complete(fixture):
    """The 4K cases chip_smoke.py holds the card against."""
    fx, meta = fixture
    for lane in ("rgb", "rgba"):
        name = f"4k_{lane}_l3"
        assert meta["cases"][name]["path"] == "fused"
        assert fx[f"{name}.owner"].shape == (270 * 480,)
        assert fx[f"{name}.bits_histogram"].sum(axis=1).tolist() == [2160 * 3840] * 3
        assert fx[f"{name}_dither_dense.psnr"] > 30
    np.testing.assert_array_equal(fx["4k_rgb_l3.alive_counts"], [129600, 20819, 1382])
    assert abs(float(fx["4k_rgb_l3.psnr"]) - 39.37082) < 1e-4


# ---------------------------------------------------------------------------
# Entry points: what is not ported raises, and nothing falls back
# ---------------------------------------------------------------------------

# the ids are the names these cases had while both were refused naming
# ROADMAP.md Queue 1 item 13 (the dense path, now landed)
@pytest.mark.parametrize("kwargs,item", [
    pytest.param(dict(coalesce=False, num_levels=1), None,
                 id="kwargs1-Queue 1 item 13"),
    pytest.param(dict(coalesce=False, num_levels=5), "small_rgb_l5_nocoalesce",
                 id="kwargs2-Queue 1 item 13"),
])
def test_unported_arguments_raise(kwargs, item):
    """num_levels=1 now encodes, on the dense path (the fused device entry
    point takes 2-4 levels and names that path); so does num_levels=5
    (Queue 1 item 16, landed), as the JAX package's recorded encode of the
    fixture case ``item`` (tests/fixtures/torch_port_levels_reference.npz:
    the owners of all but the 4 blocks of the one level-1 merge a float
    flip turns, PSNR and bpp within tests/test_torch_levels.py's tolerance
    for that flip), while the fused device entry point still refuses it,
    naming the dense path."""
    if item is not None:
        from tests import test_torch_dense as dense
        from tools import record_torch_levels_reference as lrec

        fx = np.load(lrec.OUT)
        img = lrec.SMALL_CASES[item][0]()
        cfg = EncodeConfig(error_factor=100, dithering=False)
        out = limg_tpu_torch.encode_image_merged(img, cfg, device="cpu", **kwargs)
        owner = rec.per_block(out["owner_px"])
        assert int((owner != fx[f"{item}.owner"]).sum()) <= 4
        assert abs(out["psnr"] - float(fx[f"{item}.psnr"])) <= dense.MERGE_FLIP_PSNR_DB
        assert abs(out["mean_bpp"] - float(fx[f"{item}.mean_bpp"])) <= dense.MERGE_FLIP_BPP
        np.testing.assert_allclose(out["alive_counts"], fx[f"{item}.alive_counts"], atol=1)
        with pytest.raises(ValueError, match="dense path"):
            limg_tpu_torch.encode_image_merged_fused_device(img, cfg, device="cpu", **kwargs)
        return
    img = np.zeros((16, 16, 3), np.uint8)
    out = limg_tpu_torch.encode_image_merged(img, EncodeConfig(), device="cpu", **kwargs)
    np.testing.assert_array_equal(out["decoded"][..., :3], img)
    np.testing.assert_array_equal(out["alive_counts"], [4])
    with pytest.raises(ValueError, match="dense path"):
        limg_tpu_torch.encode_image_merged_fused_device(img, EncodeConfig(), device="cpu",
                                                        **kwargs)


@pytest.mark.parametrize("kwargs", [dict(coalesce=False, return_state=True),
                                    dict(fused_layout="natural")])
def test_state_and_natural_layout_run_where_they_were_refused(kwargs):
    """``return_state=True`` and ``fused_layout="natural"`` (ROADMAP.md Queue
    1 item 10, Queue 2 row 9) now encode the input they were refused on,
    through both entry points."""
    img = np.zeros((16, 16, 3), np.uint8)
    out = limg_tpu_torch.encode_image_merged(img, EncodeConfig(), device="cpu", **kwargs)
    if kwargs.get("return_state"):
        out, state = out
        assert state["rows"].shape == (24, 4) and state["q"].shape == (3, 64, 4)
    np.testing.assert_array_equal(out["decoded"][..., :3], img)
    dev = limg_tpu_torch.encode_image_merged_fused_device(img, EncodeConfig(), device="cpu",
                                                          **kwargs)
    assert dev["decoded"].shape == (16, 16, 4)
    assert ("ser_rows" in dev) == bool(kwargs.get("return_state"))


def test_rd_policy_runs_where_it_was_refused():
    """``merge_policy="rd"`` (ROADMAP.md Queue 1 item 12) now encodes the
    input it was refused on, through both entry points."""
    img = np.zeros((16, 16, 3), np.uint8)
    out = limg_tpu_torch.encode_image_merged(img, EncodeConfig(), device="cpu", coalesce=False,
                                             merge_policy="rd")
    np.testing.assert_array_equal(out["decoded"][..., :3], img)
    np.testing.assert_array_equal(out["alive_counts"], [4, 1, 0])
    dev = limg_tpu_torch.encode_image_merged_rd_device(img, EncodeConfig(), coalesce=False,
                                                       device="cpu")
    assert dev["decoded"].shape == (16, 16, 4) and int(dev["n_runs"]) == 0


def test_default_encode_coalesces_runs():
    """coalesce=True, the JAX default, runs: JAX's keys, and runs kept on the
    smoke image of tests/test_merged_smoke.py."""
    img = rec.smoke_image()
    out = limg_tpu_torch.encode_image_merged(img, EncodeConfig(dithering=False), num_levels=2,
                                             device="cpu")
    assert set(out) == JAX_KEYS | PLANE_KEYS
    assert out["n_runs"] > 0
    assert set(out["coalesce_stats"]) == {"dropped_runs_at_capacity", "overflow_run_blocks",
                                          "rejected_runs"}
    dev = limg_tpu_torch.encode_image_merged_fused_device(img, EncodeConfig(dithering=False),
                                                          num_levels=2, device="cpu")
    assert int(dev["n_runs"]) == out["n_runs"]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        limg_tpu_torch.encode_image_merged(np.zeros((16, 16, 3), np.uint8), EncodeConfig(),
                                           coalesce=False, device="cuda")


def test_wrappers_check_their_inputs():
    words = torch.zeros((20, 24), dtype=torch.int32)
    cfg = EncodeConfig()
    with pytest.raises(ValueError):
        km.fit_levels_kernel(words.to(torch.int64), cfg, 3)
    with pytest.raises(ValueError):
        km.fit_levels_kernel(words, cfg, 5)
    fit = km.fit_levels_kernel(words, cfg, 3)
    assert fit.f8_sel.shape == (64, 9) and fit.reasons.shape == (2, 9)
    with pytest.raises(ValueError):
        km.owner_crush_kernel(words, fit.owner[:5], fit.f8_sel, fit.eps_sel, cfg, 3, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        km.fit_levels_kernel(words.to("meta"), cfg, 3)


@pytest.mark.parametrize("natural", [False, True])
def test_owner_crush_takes_only_owner_maps_uniform_over_regions(natural):
    """The crush kernels read a region's owner from any one of its blocks,
    so both plain versions take an owner map only where every block of a
    level-l region (its aligned square, cut by the grid) is owned at l."""
    from limg_tpu_torch.kernels import encode_natural as kn
    from limg_tpu_torch.regions import _words

    img = make_test_image(np.random.default_rng(3), 40, 72)     # 5 x 9 blocks
    words = _words(torch.from_numpy(img[..., :3].copy()))
    cfg = EncodeConfig()
    fit_plain, plain = ((kn.fit_levels_natural_reference, kn.owner_crush_natural_reference)
                        if natural else (km.fit_levels_reference, km.owner_crush_reference))
    fit = fit_plain(words, cfg, 3)

    def crush(cells):
        owner = torch.zeros((5, 9), dtype=torch.int32)
        for (y, x), lvl in cells.items():
            owner[y, x] = lvl
        return plain(words, owner.reshape(-1), fit.f8_sel, fit.eps_sel, cfg, 3, 0)

    crush({})
    crush({(0, 0): 1, (0, 1): 1, (1, 0): 1, (1, 1): 1})
    crush({(4, 8): 2})                   # the level-2 square's one block in the grid
    crush({(y, x): 2 for y in range(4) for x in range(4, 8)})
    for bad in ({(0, 0): 1}, {(4, 6): 1}, {(y, x): 2 for y in range(4) for x in range(4)
                                           if (y, x) != (3, 3)}):
        with pytest.raises(ValueError, match="uniform"):
            crush(bad)
    with pytest.raises(ValueError, match="levels"):
        crush({(4, 8): 3})


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """An edited header changes the library's cache key."""
    srcs = build.source_files(build.CSRC / "encode_merged.cu")
    assert {p.name for p in srcs} == {"encode_merged.cu", "encode_merged.cuh", "crush_search.cuh",
                                      "limg_common.cuh"}
    assert {p.name for p in build.source_files(build.CSRC / "encode_natural.cu")} == {
        "encode_natural.cu", "encode_merged.cuh", "crush_search.cuh", "limg_common.cuh"}
    assert {p.name for p in build.source_files(build.CSRC / "encode_fixed.cu")} == {
        "encode_fixed.cu", "region_encode.cuh", "cluster.cuh", "crush_search.cuh",
        "limg_common.cuh"}
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.source_digest("encode_fixed")
    (tmp_path / "limg_common.cuh").write_text((tmp_path / "limg_common.cuh").read_text() + "\n")
    assert build.source_digest("encode_fixed") != before



def test_build_key_of_another_checkout(tmp_path):
    """A baseline checkout's sources (tools/profile_torch_kernels.py
    --baseline) are keyed by their own text: equal to this checkout's
    while they are a copy, different once a header is edited."""
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    assert build.source_digest("encode_merged", tmp_path) == build.source_digest("encode_merged")
    (tmp_path / "encode_merged.cuh").write_text((tmp_path / "encode_merged.cuh").read_text()
                                                + "\n")
    assert build.source_digest("encode_merged", tmp_path) != build.source_digest("encode_merged")
    assert build.source_digest("encode_fixed", tmp_path) == build.source_digest("encode_fixed")
