"""limg_tpu_torch's natural-layout merged encode (``fused_layout="natural"``)
and the LTP1 serializer state (``return_state=True``) vs the JAX package
(CPU).

tests/fixtures/torch_port_natural_reference.npz holds the public output of
``limg_tpu.regions.encode_image_merged(use_pallas=True, fused=True,
fused_layout="natural", return_state=True)`` with coalescing on and off
(tools/record_torch_natural_reference.py; ``fit_levels_natural`` and
``owner_crush_natural`` in Pallas interpret mode, dithering off). On the CPU
the port runs the plain versions of its two natural kernels
(kernels/encode_natural.py).

The natural layout sums each block as a left fold over its 8 pixel rows,
then a pairwise tree over its 8 columns: XLA's order for the JAX kernel's
row fold, which the 8-row fold below holds bit for bit. On the fixture
images the fit then agrees with JAX's exactly (0 endpoint flips; pixel sums
of integers are exact in float32 in any order, so the halving and pairwise
row orders give the same there). Per image, the blocks whose outputs differ
are counted: one refit factor of one run block on 256x384 RGBA, which sits
one rounding step from a crush bucket's edge (the JAX package extracts
refit factors in its jitted graph; the same block differs on the Morton
path, tests/test_torch_coalesce.py).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from limg_tpu import bitstream
from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.pallas_kernels import encode_natural as jn
from limg_tpu.pallas_kernels.encode_fixed import KernelSpec

import limg_tpu_torch
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import encode_natural as kn
from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops import reduce as reduce_mod
from limg_tpu_torch.ops.morton import MortonOrder
from limg_tpu_torch.ops.reduce import nat_block_sum, nat_pairwise, pairwise_tree, tree_sum
from limg_tpu_torch.regions import _words
from tests.conftest import make_test_image
from tools import record_torch_merged_reference as mrec
from tools import record_torch_natural_reference as nrec

torch.set_num_threads(1)

PSNR_DB, BPP, OWNER_AGREE, RUNS_FRAC = 0.02, 0.01, 0.995, 0.02
# blocks whose outputs differ from the fixture's, per image (see above)
DIFFERING_BLOCKS = {"small_rgba_l3": 1, "small_rgba_l4": 1}
# serializer columns of make_4k(256, 384) at 3 levels that the halving tree,
# in place of the natural layout's block-sum order, moves in both layouts
NATURAL_ORDER_MOVES = {"rgb": 14, "rgba": 0}
# the tiny images whose full planes and state the fixture holds
FULL_PLANE_CASES = [n for n, c in nrec.CASES.items() if c[4]]


@pytest.fixture(scope="module")
def fixture():
    fx = np.load(nrec.OUT)
    return fx, json.loads(str(fx["meta"]))


def _case(name):
    make, levels, over, coalesce, full = nrec.CASES[name]
    return make(), levels, EncodeConfig(**mrec.config_kwargs(over)), coalesce, full


def _encode(name, **kw):
    img, levels, cfg, coalesce, _ = _case(name)
    return limg_tpu_torch.encode_image_merged(img, cfg, seed=0, num_levels=levels,
                                              coalesce=coalesce, return_state=True,
                                              fused_layout="natural", device="cpu", **kw)


# ---------------------------------------------------------------------------
# The natural reducers and layout helpers
# ---------------------------------------------------------------------------

def test_nat_block_sum_is_the_jax_kernels_fold():
    """nat_block_sum equals the JAX kernel's fold_sum (8-row fold, then lane
    butterflies) in interpret mode, bit for bit, on random floats."""
    rng = np.random.default_rng(0)
    tile = (rng.standard_normal((64, 512)) * rng.uniform(0.01, 100, (64, 512))).astype(np.float32)

    def kernel(x_ref, o_ref):
        o_ref[...] = jn._NatRowOps(512).fold_sum(x_ref[...])

    want = np.asarray(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((8, 512), jnp.float32),
                                     interpret=True)(tile))
    blocks, _, _ = layout.blockify_words(torch.from_numpy(tile.view(np.int32)))
    got = nat_block_sum(blocks.view(torch.float32)).reshape(8, 64).numpy()
    np.testing.assert_array_equal(got, want[:, ::8])
    np.testing.assert_array_equal(want[:, ::8], want[:, 7::8])


@pytest.mark.parametrize("side", [2, 4, 8])
def test_nat_pairwise_pairs_blocks_as_the_morton_tree(side):
    """x pairs then y pairs on a row-major grid: the Morton pairwise tree."""
    by, bx = 16, 24
    levels = side.bit_length()
    row = torch.from_numpy(np.random.default_rng(side).standard_normal((2, by * bx))
                           .astype(np.float32))
    order = MortonOrder(by, bx, levels, torch.device("cpu"))
    want = order.restore(pairwise_tree(order.embed(row), side * side, torch.add))
    assert torch.equal(nat_pairwise(row, bx, side, torch.add), want)


def test_block_plane_and_padded_blockify():
    words = torch.arange(20 * 28, dtype=torch.int32).reshape(20, 28)
    grid = layout.grid_for(20, 28)
    packed, mask, g = layout.blockify_words(words)
    plane = layout.block_plane(packed, grid)
    assert plane.shape == (24, 32)
    assert torch.equal(plane[:20, :28], words) and not plane[20:].any()
    padded = layout.BlockGrid(20, 28, 4, 6)
    p2, m2, g2 = layout.blockify_words(words, grid=padded)
    assert p2.shape == (64, 24) and g2.blocks_x == 6
    assert torch.equal(p2.reshape(64, 4, 6)[:, :3, :4].reshape(64, -1), packed)
    assert torch.equal(m2.reshape(64, 4, 6)[:, :3, :4].reshape(64, -1), mask)
    assert not m2.reshape(64, 4, 6)[:, 3:].any()


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the JAX Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_alpha", [False, True])
def test_natural_kernels_match_jax_pallas_kernels(has_alpha):
    """fit_levels_natural and owner_crush_natural in interpret mode against
    the port's plain versions on the same (edge-padded) image: equal."""
    img = np.ascontiguousarray(nrec.serializer_image()[:37, :69])
    h, w = img.shape[:2]
    cfg = EncodeConfig(error_factor=100, has_alpha=has_alpha, dithering=False)
    jcfg = JConfig(error_factor=100, has_alpha=has_alpha, dithering=False)
    ch, levels = cfg.channels, 2
    words = _words(torch.from_numpy(img if has_alpha else np.ascontiguousarray(img[..., :3])))
    grid = layout.grid_for(h, w)
    p2 = jnp.asarray(layout.block_plane(layout.blockify_words(words)[0], grid).numpy())
    params = jnp.asarray([0, cfg.max_pixel_bit_crush_error, cfg.max_block_bit_crush_error],
                         jnp.int32)
    kspec = KernelSpec.from_config(jcfg)
    f8_j, rows_j = jn.fit_levels_natural(p2, params, kspec, levels, True, (h, w))
    rows = np.asarray(jn.rows_to_blocks(rows_j, grid.blocks_y, grid.blocks_x))
    fit = kn.fit_levels_natural_reference(words, cfg, levels)
    np.testing.assert_array_equal(fit.f8_sel.numpy(), np.asarray(f8_j))
    np.testing.assert_array_equal(fit.cnt0.numpy(), rows[0])
    np.testing.assert_array_equal(fit.eps_sel.reshape(-1, grid.num_blocks).numpy(),
                                  rows[1:1 + 6 * ch])
    np.testing.assert_array_equal(fit.avg_sel.numpy(), rows[1 + 6 * ch:1 + 7 * ch])
    np.testing.assert_array_equal(fit.owner.numpy(), rows[1 + 7 * ch])
    np.testing.assert_array_equal(fit.stats_bits.numpy(), rows[2 + 7 * ch])
    np.testing.assert_array_equal(fit.reasons.numpy(), rows[3 + 7 * ch:])

    rows_in = jnp.concatenate([rows_j[1 + 7 * ch:2 + 7 * ch], rows_j[1:1 + 6 * ch]], axis=0)
    q_j, dec_j, orows_j = jn.owner_crush_natural(p2, f8_j, rows_in, params, kspec, levels, True,
                                                 (h, w), emit_q=True)
    orows = np.asarray(jn.rows_to_blocks(orows_j, grid.blocks_y, grid.blocks_x))
    crush = kn.owner_crush_natural_reference(words, fit.owner, fit.f8_sel, fit.eps_sel, cfg,
                                             levels, 0)
    np.testing.assert_array_equal(crush.q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(crush.dec.numpy()[:h, :w], np.asarray(dec_j)[:h, :w])
    np.testing.assert_array_equal(crush.shifts.numpy(), orows[:3])
    np.testing.assert_array_equal(crush.dist.numpy(), orows[3])
    np.testing.assert_array_equal(crush.dist_blk.numpy(), orows[4])
    np.testing.assert_array_equal(crush.bpp.numpy(), orows[5])


def test_natural_wrappers_check_their_inputs():
    words = torch.zeros((20, 24), dtype=torch.int32)
    cfg = EncodeConfig()
    fit = kn.fit_levels_natural_kernel(words, cfg, 3)
    assert fit.f8_sel.shape == (24, 24) and fit.eps_sel.shape == (6, 3, 9)
    with pytest.raises(ValueError):
        kn.owner_crush_natural_kernel(words, fit.owner, fit.f8_sel[:8], fit.eps_sel, cfg, 3, 0)
    with pytest.raises(ValueError):
        kn.fit_levels_natural_kernel(words, cfg, 5)
    with pytest.raises(RuntimeError, match="no kernel"):
        kn.fit_levels_natural_kernel(words.to("meta"), cfg, 3)


# ---------------------------------------------------------------------------
# The whole encode against the fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(nrec.CASES))
def test_port_matches_jax_natural_fixture(fixture, name):
    fx, meta = fixture
    img, levels, cfg, coalesce, full = _case(name)
    assert meta["cases"][name]["coalesce"] == coalesce

    def ref(key):
        return fx[f"{name}.{key}"]

    out, state = _encode(name)
    ep_diff = np.abs(out["endpoint_rows"].astype(np.int64) - ref("endpoint_rows")).max(axis=0)
    owner = mrec.per_block(out["owner_px"])
    q_hash = mrec.block_hashes(state["q"].transpose(2, 1, 0).reshape(-1, 8, 3))
    differ = ((owner != ref("owner")) | (ep_diff > 0)
              | (mrec.per_block(out["shift"]) != ref("shifts")).any(axis=0)
              | (mrec.per_block(out["bpp"]) != ref("bpp"))
              | (mrec.per_block(out["region_id"]) != ref("region_id"))
              | (mrec.block_hashes(out["factors"]) != ref("factors_hash"))
              | (mrec.block_hashes(out["decoded"]) != ref("decoded_hash"))
              | (state["rows"] != ref("state_rows")).any(axis=0) | (q_hash != ref("state_q_hash")))
    print(f"{name}: {int(differ.sum())} of {differ.size} blocks differ, endpoint flips "
          f"{int((ep_diff == 1).sum())}, psnr {out['psnr'] - float(ref('psnr')):+.7f} dB, "
          f"runs {out['n_runs']} vs {int(ref('n_runs'))}")
    assert ep_diff.max() <= 1
    assert differ.sum() <= DIFFERING_BLOCKS.get(name, 0)
    assert (owner == ref("owner")).mean() >= OWNER_AGREE
    assert abs(out["psnr"] - float(ref("psnr"))) <= PSNR_DB
    assert abs(out["mean_bpp"] - float(ref("mean_bpp"))) <= BPP
    n_runs_j = int(ref("n_runs"))
    assert abs(out["n_runs"] - n_runs_j) <= RUNS_FRAC * n_runs_j
    assert state["n_runs"] == out["n_runs"]
    np.testing.assert_array_equal(out["alive_counts"], ref("alive_counts"))
    assert [out["coalesce_stats"].get(k, 0) for k in nrec.STAT_KEYS] == \
        ref("coalesce_stats").tolist()
    if coalesce:
        pre = limg_tpu_torch.fused_merged_pre(img, cfg, num_levels=levels, need_q=False,
                                              fused_layout="natural", device="cpu")
        np.testing.assert_array_equal(pre["seg0"].numpy(), ref("seg0"))
        np.testing.assert_array_equal(pre["is_run0"].numpy(), ref("is_run0").astype(bool))
    if full:
        np.testing.assert_array_equal(out["decoded"], ref("decoded"))
        np.testing.assert_array_equal(out["factors"], ref("factors"))
        np.testing.assert_array_equal(state["q"], ref("state_q"))


@pytest.mark.parametrize("name", FULL_PLANE_CASES)
def test_jax_serializer_writes_jax_bytes_from_the_port_state(fixture, name):
    """limg_tpu.bitstream.serialize_from_state turns the port's state into
    the bytes it writes from JAX's own state (0-flip images), and its
    deserialize decodes them to the port's decoded image."""
    fx, _ = fixture
    img, levels, cfg, coalesce, _ = _case(name)
    jcfg = JConfig(**mrec.config_kwargs(nrec.CASES[name][2]))
    out, state = _encode(name)
    jstate = dict(height=img.shape[0], width=img.shape[1], num_levels=levels,
                  channels=cfg.channels, rows=fx[f"{name}.state_rows"], q=fx[f"{name}.state_q"],
                  n_runs=int(fx[f"{name}.n_runs"]))
    blob = bitstream.serialize_from_state(state, jcfg)
    assert blob == bitstream.serialize_from_state(jstate, jcfg)
    decoded, _ = bitstream.deserialize(blob)
    np.testing.assert_array_equal(decoded[..., :cfg.channels], out["decoded"][..., :cfg.channels])


# ---------------------------------------------------------------------------
# Natural against Morton, port against port (tests/test_natural.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("has_alpha", [False, True])
def test_natural_matches_morton(has_alpha):
    img = make_test_image(np.random.default_rng(881), h=70, w=150)
    if not has_alpha:
        img = img[:, :, :3].copy()
    img[0:32, :, :3] = [40, 90, 200]
    cfg = EncodeConfig(error_factor=100, has_alpha=has_alpha, dithering=False)
    m = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=3, device="cpu")
    n = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=3, fused_layout="natural",
                                           device="cpu")
    assert n["psnr"] == pytest.approx(m["psnr"], abs=0.05)
    assert n["mean_bpp"] == pytest.approx(m["mean_bpp"], abs=0.02)
    assert (n["decoded"] == m["decoded"]).mean() > 0.999
    for key in ("owner_px", "alive_counts", "region_id"):
        np.testing.assert_array_equal(n[key], m[key], err_msg=key)
    assert n["n_runs"] == m["n_runs"] and n["coalesce_stats"] == m["coalesce_stats"]


def _assert_same_encode(a, st_a, b, st_b):
    for key in ("decoded", "factors", "owner_px", "region_id", "shift", "bpp", "alive_counts",
                "endpoint_rows"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for key in ("psnr", "mean_bpp", "n_runs", "coalesce_stats", "merge_stats"):
        assert a[key] == b[key], key
    np.testing.assert_array_equal(st_a["rows"], st_b["rows"])
    np.testing.assert_array_equal(st_a["q"], st_b["q"])


@pytest.mark.parametrize("lane,dithering", [("rgb", False), ("rgb", True), ("rgba", True)])
def test_natural_in_the_morton_block_order_equals_morton(monkeypatch, lane, dithering):
    """The layouts differ only in the order of a block's float sums, and
    both take the natural layout's: the natural encode equals the Morton one
    bit for bit, state included. With the halving tree in place of
    nat_block_sum the two stay equal, and the halving tree moves
    ``NATURAL_ORDER_MOVES`` serializer columns."""
    img = mrec.make_4k_lane(*mrec.SMALL, lane)
    cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dithering)

    def both():
        return [limg_tpu_torch.encode_image_merged(img, cfg, num_levels=3, return_state=True,
                                                   fused_layout=layout_, device="cpu")
                for layout_ in ("morton", "natural")]

    (m, st_m), (n, st_n) = both()
    _assert_same_encode(n, st_n, m, st_m)
    halving = functools.partial(tree_sum, dim=-2)
    monkeypatch.setattr(reduce_mod, "nat_block_sum", halving)
    (mh, st_mh), (nh, st_nh) = both()
    _assert_same_encode(nh, st_nh, mh, st_mh)
    moved = int((st_mh["rows"] != st_m["rows"]).any(axis=0).sum())
    print(f"{lane} dithering={dithering}: the halving tree moves {moved} serializer columns")
    assert moved == NATURAL_ORDER_MOVES[lane]


@pytest.mark.parametrize("lane,levels,dithering", [("rgb", 2, False), ("rgba", 3, True),
                                                   ("rgb", 4, True), ("rgba", 2, False)])
def test_natural_encode_equals_morton_bit_for_bit(lane, levels, dithering):
    """The port's natural-layout encode equals its Morton encode bit for
    bit, state included, as the JAX package's layouts agree
    (tests/test_natural.py); here on an edge-padded image with a flat band
    (merges at every level)."""
    img = make_test_image(np.random.default_rng(levels), h=77, w=141)
    img[8:40, :, :3] = [40, 90, 200]
    if lane == "rgb":
        img = np.ascontiguousarray(img[:, :, :3])
    cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dithering)
    m, st_m = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels, return_state=True,
                                                 device="cpu")
    n, st_n = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels, return_state=True,
                                                 fused_layout="natural", device="cpu")
    assert m["n_runs"] > 0 and m["alive_counts"][1] > 0
    _assert_same_encode(n, st_n, m, st_m)


@pytest.mark.parametrize("dithering", [False, True])
def test_natural_serializer_state_matches_morton(dithering):
    img = make_test_image(np.random.default_rng(7), h=40, w=72)
    img[:16, :, :3] = [120, 60, 200]
    cfg = EncodeConfig(error_factor=100, dithering=dithering)
    _, st_m = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=2, return_state=True,
                                                 device="cpu")
    _, st_n = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=2, return_state=True,
                                                 fused_layout="natural", device="cpu")
    assert set(st_n) == {"height", "width", "num_levels", "channels", "rows", "q", "n_runs"}
    np.testing.assert_array_equal(st_m["rows"], st_n["rows"])
    np.testing.assert_array_equal(st_m["q"], st_n["q"])


@pytest.mark.parametrize("policy", ["match", "rd"])
def test_state_of_both_policies_round_trips_through_ltp1(policy):
    """return_state=True for the match and RD policies: the JAX package's
    serializer packs the port's state and decodes the stream to the port's
    decoded image."""
    img = mrec.make_4k_lane(64, 96, "rgba")
    cfg = EncodeConfig(error_factor=100, has_alpha=True, dithering=True)
    out, state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=3, merge_policy=policy,
                                                    return_state=True, device="cpu")
    assert state["rows"].shape == (6 * 4 + 6, 12 * 8) and state["rows"].dtype == np.int32
    assert state["q"].shape == (3, 64, 96) and state["q"].dtype == np.uint8
    assert state["n_runs"] == out["n_runs"] > 0
    decoded, _ = bitstream.deserialize(bitstream.serialize_from_state(
        state, JConfig(error_factor=100, has_alpha=True)))
    np.testing.assert_array_equal(decoded, out["decoded"])


def test_layout_arguments_are_checked():
    img = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="fused_layout"):
        limg_tpu_torch.encode_image_merged(img, EncodeConfig(), fused_layout="tiled",
                                           device="cpu")
    state = limg_tpu_torch.fused_merged_pre(img, EncodeConfig(), fused_layout="natural",
                                            device="cpu")
    with pytest.raises(ValueError, match="natural"):
        limg_tpu_torch.fused_merged_finish(state, EncodeConfig(), 0, 3, True, 4)
    out = limg_tpu_torch.fused_merged_finish(state, EncodeConfig(), 0, 3, True, 4,
                                             return_state=True, fused_layout="natural")
    assert out["ser_rows"].shape == (24, 4) and out["ser_q"].dtype == torch.uint8
