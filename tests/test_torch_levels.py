"""limg_tpu_torch's dense merged path at 5 and 6 quadtree levels (128x128 and
256x256 pixel regions) and its two kernels' plain versions at P = 16,384
and up, against the JAX package on the CPU.

- Dense encodes against tests/fixtures/torch_port_levels_reference.npz
  (tools/record_torch_levels_reference.py: the JAX dense jnp path,
  dithering off) at 5 and 6 levels, both policies (RD charging LTP1's real
  region header), coalescing on and off, ``cap_frac`` 8, a ragged 70x90
  image, an exhaustive ``num_factors=2`` case and an image whose level-4
  regions merge and run. Per block the owner level, shifts, bpp, region
  id, endpoints, run flag and the planes' hashes must equal the fixture's
  outside the blocks a float add-order flip moves (``FLIPS``, as in
  tests/test_torch_dense.py); PSNR within 1e-3 dB and mean bpp within
  1e-4, or 5e-3 / 5e-3 where a flip turns a merge decision.
- The LTP1 stream at 5 levels: the port writes JAX's bytes from the same
  state, and its ``deserialize`` refuses them with JAX's ValueError, as
  JAX's does (the reference's own behaviour, ROADMAP.md Queue 3).
- The region encode's plain version at P = 16,384 and 65,536 against JAX's
  jnp ``encode_blocks``; the segment encode's at P = 16,384 and 65,536
  against JAX's jnp composition; ``evaluate_shifts`` on a 512x512 px
  region whose pre-scaled block-error sum passes 2^31 and wraps in int32,
  as in JAX.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.ops import crush as jcrush
from limg_tpu.ops.fit import Decomposition as JDecomposition

import limg_tpu_torch
from limg_tpu_torch import bitstream as tb
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.ops import crush as tcrush
from limg_tpu_torch.ops.fit import Decomposition
from tests import test_torch_dense as dense
from tests import test_torch_region_encode as region
from tools import record_torch_dense_reference as drec
from tools import record_torch_levels_reference as rec
from tools import record_torch_merged_reference as mrec

torch.set_num_threads(1)

# per fixture case, the level-0 blocks whose outputs may differ from JAX's
# by float add order, and how many of them may change owner level
# (ROADMAP.md Queue 3). They are tests/test_torch_dense.py's flips of the
# same images, block for block (levels 4 and up own no pixel there): on the
# 256x384 RGB image one level-0 block's fit is one endpoint apart from
# JAX's, which turns level-1 region 130's merge (blocks 500, 501, 548, 549)
# and, with coalescing, the runs around it (14 blocks, as its 4-level case);
# on the RGBA image block 79 (as its 3-level case). The 70x90, RD, flat-top
# and exhaustive cases have none, and their states are JAX's.
FLIPS = {name: (0, 0) for name in rec.SMALL_CASES}
FLIPS.update({
    "small_rgb_l5": (14, 4), "small_rgb_l6": (14, 4), "small_rgb_l5_cap8": (14, 4),
    "small_rgb_l5_nocoalesce": (4, 4), "small_rgba_l5": (1, 0), "small_rgba_l6": (1, 0),
})

_encodes: dict = {}


@pytest.fixture(scope="module")
def fixture():
    fx = np.load(rec.OUT)
    return fx, json.loads(str(fx["meta"]))


def _port_encode(name: str, meta: dict):
    """The port's CPU encode of fixture case ``name`` (made once a process)."""
    if name not in _encodes:
        m = meta["cases"][name]
        cfg = EncodeConfig(**m["config"])
        _encodes[name] = cfg, limg_tpu_torch.encode_image_merged(
            rec.SMALL_CASES[name][0](), cfg, seed=0, num_levels=m["levels"],
            merge_policy=m["merge_policy"], coalesce=m["coalesce"], cap_frac=m["cap_frac"],
            rd_header_bits=m["rd_header_bits"], return_state=True, device="cpu")
    return _encodes[name]


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_levels_encode_equals_jax_fixture(fixture, name):
    fx, meta = fixture
    cfg, (out, state) = _port_encode(name, meta)
    levels = meta["cases"][name]["levels"]
    assert len(out["alive_counts"]) == levels >= 5
    n_flips, n_owner = FLIPS[name]
    flipped = dense._per_block_differences(out, state, fx, name)
    assert flipped.size <= n_flips, f"{name}: blocks that differ: {flipped[:20]}"
    owner_flips = int((mrec.per_block(out["owner_px"]) != fx[f"{name}.owner"]).sum())
    assert owner_flips <= n_owner
    psnr_db, bpp = ((dense.MERGE_FLIP_PSNR_DB, dense.MERGE_FLIP_BPP) if owner_flips
                    else (dense.PSNR_DB, dense.BPP))
    assert abs(out["psnr"] - float(fx[f"{name}.psnr"])) <= psnr_db
    assert abs(out["mean_bpp"] - float(fx[f"{name}.mean_bpp"])) <= bpp
    np.testing.assert_allclose(out["alive_counts"], fx[f"{name}.alive_counts"],
                               atol=owner_flips // 4)
    hist_l1 = int(np.abs(out["bits_histogram"] - fx[f"{name}.bits_histogram"]).sum())
    assert hist_l1 <= 2 * 3 * 64 * flipped.size
    assert abs(out["n_runs"] - int(fx[f"{name}.n_runs"])) <= (flipped.size > 0)
    stats = np.asarray([out["coalesce_stats"].get(k, 0) for k in drec.STAT_KEYS])
    assert (np.abs(stats - fx[f"{name}.coalesce_stats"]) <= flipped.size).all()
    keys = meta["cases"][name]["merge_keys"]
    got = np.asarray([[s[k] for k in keys] for s in out["merge_stats"]]).reshape(-1, len(keys))
    np.testing.assert_allclose(got, fx[f"{name}.merge_stats"].reshape(-1, len(keys)),
                               rtol=1e-4, atol=owner_flips)
    assert state["q"].shape == (64, mrec.per_block(out["owner_px"]).size)


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_levels_state_and_stream_equal_jax(fixture, name):
    """Where the port's serializer state is JAX's (its SHA-256; in every case
    with no flipped block), its streams are JAX's, entropy on and off; the
    port's ``deserialize`` refuses them with JAX's ValueError, as JAX's own
    ``deserialize`` does at 5 levels or more."""
    fx, meta = fixture
    cfg, (out, state) = _port_encode(name, meta)
    same = drec.state_digest(state) == str(fx[f"{name}.state_sha256"])
    assert same or FLIPS[name][0] > 0
    for entropy, tag in ((True, "stream"), (False, "stream_raw")):
        blob = tb.serialize_from_state(state, cfg, entropy=entropy)
        if same:
            assert drec.stream_digest(blob) == str(fx[f"{name}.{tag}_sha256"])
            assert len(blob) == int(fx[f"{name}.{tag}_len"])
        with pytest.raises(ValueError, match="bad dimensions/levels"):
            tb.deserialize(blob)
    if f"{name}.state_rows" in fx.files:
        np.testing.assert_array_equal(state["rows"], fx[f"{name}.state_rows"])
        np.testing.assert_array_equal(state["q"], fx[f"{name}.state_q"])


def test_4k_levels_fixture_is_complete(fixture):
    """The 4K cases chip_smoke.py phase 3i holds the card against."""
    fx, meta = fixture
    for name, (_, levels, _) in rec.FULL_CASES.items():
        assert meta["cases"][name]["height"] == 2160 and meta["cases"][name]["levels"] == levels
        assert fx[f"{name}.owner"].shape == (270 * 480,)
        assert fx[f"{name}.alive_counts"].shape == (levels,)
        assert fx[f"{name}.bits_histogram"].sum(axis=1).tolist() == [2160 * 3840] * 3
        assert fx[f"{name}.n_runs"] > 0 and len(str(fx[f"{name}.stream_sha256"])) == 64
    assert fx["4k_rgb_l5.alive_counts"][4] > 0


def test_five_levels_route_to_the_dense_path():
    """fused=None takes the dense path at 5 levels or more (the fused path
    stops at 4, as the JAX package's MAX_FUSED_LEVELS), equal to
    fused=False and to the dense device entry point; fused=True and the
    fused entry points refuse, naming the dense path."""
    img = mrec.fused_band_image()
    cfg = EncodeConfig(error_factor=100, dithering=False)
    default = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=5, device="cpu")
    dense_out = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=5, fused=False,
                                                   device="cpu")
    np.testing.assert_array_equal(default["decoded"], dense_out["decoded"])
    assert default["alive_counts"].tolist() == dense_out["alive_counts"].tolist()
    assert default["n_runs"] == dense_out["n_runs"] and len(default["alive_counts"]) == 5
    dev = limg_tpu_torch.encode_image_merged_device(img, cfg, num_levels=5, device="cpu")
    np.testing.assert_array_equal(dev["decoded"].numpy(), default["decoded"])
    for fn in (limg_tpu_torch.encode_image_merged_fused_device,
               limg_tpu_torch.encode_image_merged_rd_device,
               limg_tpu_torch.fused_merged_pre, limg_tpu_torch.fused_rd_pre):
        with pytest.raises(ValueError, match="dense path"):
            fn(img, cfg, num_levels=5, device="cpu")
    with pytest.raises(ValueError, match="dense path"):
        limg_tpu_torch.encode_image_merged(img, cfg, num_levels=5, fused=True, device="cpu")


def test_eight_levels_give_grids_of_one_region():
    """No upper cap: at 8 levels the 70x90 image's levels 4-7 are each one
    region larger than the image (a 1x1 grid), and the encode decodes the
    same image as at 5 levels, whose levels 4 and up own no pixel."""
    img = mrec.fused_band_image()
    cfg = EncodeConfig(error_factor=100, dithering=False)
    five = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=5, device="cpu")
    eight = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=8, device="cpu")
    assert eight["alive_counts"].tolist()[:5] == five["alive_counts"].tolist()
    assert eight["alive_counts"].tolist()[5:] == [0, 0, 0]
    np.testing.assert_array_equal(eight["decoded"], five["decoded"])
    assert eight["psnr"] == five["psnr"] and eight["n_runs"] == five["n_runs"]


# ---------------------------------------------------------------------------
# The two kernels' plain versions at P >= 16,384 against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,channels,mode,num_factors", [
    (16384, 3, "ladder", 3), (16384, 4, "exhaustive", 3), (65536, 4, "ladder", 1),
    (65536, 3, "guess", 3),
])
def test_large_region_encode_matches_jax(monkeypatch, p, channels, mode, num_factors):
    """encode_blocks_reference at 128x128 and 256x256 px regions against
    JAX's jnp encode_blocks (limg_tpu/regions.py:191 runs it there) on
    edge-padded images of 2x3 and 2x2 regions."""
    monkeypatch.setitem(region.IMAGE, 16384, (200, 300))
    monkeypatch.setitem(region.IMAGE, 65536, (300, 400))
    agree = region._compare(p, channels, mode, num_factors)
    assert agree.all()


@pytest.mark.parametrize("p,n", [(16384, 6), (65536, 4)])
@pytest.mark.parametrize("ch", [3, 4])
@pytest.mark.parametrize("mode,nf", [("ladder", 3), ("exhaustive", 2)])
def test_large_segment_encode_equals_jax(p, n, ch, mode, nf):
    """segment_encode_reference on run buffers of 128x128 and 256x256 px
    regions (segments of 1-8 regions, a tail with no member, lane 0
    saturated) against JAX's jnp composition (limg_tpu/regions.py:737-772),
    with tests/test_torch_dense.py's allowance of one segment whose
    endpoints a float flip moves."""
    dense.check_segment_encode_against_jax(p, n, ch, mode, nf)


@pytest.mark.parametrize("ch", [3, 4])
def test_block_error_sum_wraps_as_in_jax(ch):
    """A 512x512 px region (P = 262,144), 15/16 white and 1/16 black, decoded
    to black: each white pixel errs 585,225 (RGB) or 780,300 (RGBA), 36,576
    or 48,768 after the pre-scale by 16, so the block error passes 2^31 and
    wraps in int32 (JAX's jnp sum; the port's plain version and kernels sum
    in int32 the same way)."""
    p = 262144
    px = np.full((ch, p, 1), 255, np.int32)
    px[:, : p // 16] = 0
    mask = np.ones((p, 1), np.int32)
    f8 = np.zeros((3, p, 1), np.int32)
    eps = [np.zeros((ch, 1), np.int32)] * 6
    avg = np.zeros((ch, 1), np.float32)
    shifts = np.array([[8], [0], [0]], np.int32)
    pm_j, be_j = jcrush.evaluate_shifts(
        jnp.asarray(px), jnp.asarray(mask), jnp.asarray(f8),
        JDecomposition(jnp.asarray(avg), *(jnp.asarray(e) for e in eps)), jnp.asarray(shifts), ch)
    pm_t, be_t = tcrush.evaluate_shifts(
        torch.from_numpy(px), torch.from_numpy(mask), torch.from_numpy(f8),
        Decomposition(torch.from_numpy(avg), *(torch.from_numpy(e) for e in eps)),
        torch.from_numpy(shifts), ch)
    per_px = 585225 if ch == 3 else 780300
    exact = (per_px >> 4) * (p - p // 16)
    assert exact > 2**31
    wrapped = (exact + 2**31) % 2**32 - 2**31
    assert int(be_t[0]) == int(np.asarray(be_j)[0]) == wrapped
    assert int(pm_t[0]) == int(np.asarray(pm_j)[0]) == per_px
