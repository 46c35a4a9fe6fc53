"""limg_tpu_torch's dense merged path (``encode_image_merged(fused=False)``,
and every 1-level encode) and its segment encode at P = 256, 1024 and 4096,
against the JAX package on the CPU.

- The segment encode's plain version (kernels/coalesce.py
  ``segment_encode_reference``) against the JAX package's jnp composition
  (limg_tpu/regions.py:737-772: ``fit_segments`` and
  ``find_shifts_segments`` with ``contiguous=True``, the factors, the
  forced drops, ``dither_crush`` off and ``decode_blocks``) on seeded run
  buffers of 16x16, 32x32 and 64x64 pixel regions, among them a saturated
  64x64 region whose unscaled error sum passes 2^31.
- Dense encodes against tests/fixtures/torch_port_dense_reference.npz
  (tools/record_torch_dense_reference.py: the JAX dense jnp path, dithering
  off) at 1-4 levels, both policies, coalescing on and off, ``cap_frac`` 0,
  8 and -300; and two direct runs of the JAX dense path on tiny images.
  Per block the owner level, shifts, bpp, region id, endpoints and the run
  flag, the factor and decoded planes' hashes, the stats, ``n_runs`` and
  ``coalesce_stats`` must equal the fixture's outside the blocks a float
  add-order flip moves (tests/test_jax_vs_golden.py:68-71): each case
  states how many it allows (``FLIPS``); PSNR agrees within 1e-3 dB and
  mean bpp within 1e-4, or within 5e-3 / 5e-3 where a flip turns a merge
  decision (ROADMAP.md Queue 3).
- The LTP1 stream: where the port's serializer state equals JAX's (its
  SHA-256), the port's streams have JAX's SHA-256 and length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu import bitstream as jb
from limg_tpu import regions as jregions
from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops.decode import decode_blocks as j_decode_blocks
from limg_tpu.ops.dither import dither_crush as j_dither_crush
from limg_tpu.ops.factors import extract_factors as j_extract, quantize_factors as j_quantize
from limg_tpu.ops.fit import drop_decomposition_axes as j_drop
from limg_tpu.ops.segments import fit_segments as j_fit_segments
from limg_tpu.ops.segments import find_shifts_segments as j_find_shifts_segments

import limg_tpu_torch
from limg_tpu_torch import bitstream as tb
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import coalesce as kc
from limg_tpu_torch.ops.decode import decode_blocks
from limg_tpu_torch.ops.error import weighted_error
from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
from limg_tpu_torch.ops.fit import fit_regions
from limg_tpu_torch.ops.reduce import SegmentReducer
from chip_smoke import region_run_buffer
from tools import record_torch_dense_reference as rec
from tools import record_torch_merged_reference as mrec

torch.set_num_threads(1)

PSNR_DB, BPP = 1e-3, 1e-4
# where a merge decision flips (the owner map differs): a level-1 region of
# 4 level-0 blocks, 0.26% of the pixels, moves PSNR by 3.7e-3 dB and bpp by
# up to 3.9e-3
MERGE_FLIP_PSNR_DB, MERGE_FLIP_BPP = 5e-3, 5e-3
# per fixture case, the level-0 blocks whose outputs may differ from JAX's
# by float add order, and how many of them may change owner level
# (ROADMAP.md Queue 3): on the 256x384 RGB image one level-0 block's fit
# is one endpoint apart from JAX's, which flips level-1 region 130's merge
# (its 4 blocks) and the runs around it; elsewhere a run's refit or a
# factor one rounding step from a crush bucket's edge
FLIPS = {name: (0, 0) for name in rec.SMALL_CASES}
FLIPS.update({
    "small_rgb_l1": (3, 0), "small_rgba_l1_rd": (9, 0), "small_rgb_l2": (14, 4),
    "small_rgba_l3": (1, 0), "small_rgb_l4": (14, 4), "small_rgb_l3_nocoalesce": (4, 4),
    "small_rgb_l3_cap8": (14, 4), "small_rgb_l3_cap300": (14, 4),
})
# segment encode: segments whose endpoints may be one apart from JAX's, per
# buffer (none on these buffers; one on a 32x32 px RGB buffer of another
# seed, in every crush setting)
SEGMENT_FLIPS = 1


# ---------------------------------------------------------------------------
# The segment encode at P = 256, 1024, 4096 against the JAX composition
# ---------------------------------------------------------------------------

def _run_buffer(p: int, n: int, ch: int, seed: int):
    """chip_smoke.py's seeded run buffer of n regions of p pixels (a tail of
    lanes with no member; at p >= 4096 lane 0 a saturated region, 15/16
    white and 1/16 black) as NumPy arrays (words, mask, seg, blocks)."""
    buf = region_run_buffer(np.random.default_rng(seed), p, n, ch, "cpu", empty_tail=2,
                            saturate=p >= 4096)
    return tuple(t.numpy() for t in buf)


def _jax_segment_encode(words, mask, seg, cfg: JConfig):
    """limg_tpu/regions.py:737-772, the jnp branch of coalesce_segments
    (dithering off): (shifts, eps (6, ch, n), avg, q (3, P, n), decoded
    (ch, P, n)) as NumPy arrays."""
    ch, n = cfg.channels, words.shape[1]
    w = jnp.asarray(words)
    px = jnp.stack([(w >> (8 * c)) & 0xFF for c in range(ch)])
    m, s = jnp.asarray(mask), jnp.asarray(seg)
    d = j_fit_segments(px, m, s, n, ch, contiguous=True)
    if cfg.num_factors < 3:
        d = j_drop(d, cfg.num_factors)
    f8_u8 = j_quantize(*j_extract(px, d, ch))
    shifts, _ = j_find_shifts_segments(px, m, f8_u8, d, s, n, cfg, contiguous=True)
    if cfg.num_factors < 3:
        forced = jnp.asarray([0] * cfg.num_factors + [8] * (3 - cfg.num_factors), jnp.int32)
        shifts = jnp.maximum(shifts, forced[:, None])
    f8 = jnp.stack([f.astype(jnp.int32) for f in f8_u8])
    q = j_dither_crush(None, f8, shifts, enabled=False)
    dec = j_decode_blocks(q, shifts, d, ch)
    return (np.asarray(shifts), np.stack([np.asarray(e) for e in d[1:]]), np.asarray(d.avg),
            np.asarray(q), np.asarray(dec))


SEGMENT_SETTINGS = [("ladder", 3), ("ladder", 2), ("exhaustive", 1), ("guess", 3)]


@pytest.mark.parametrize("p,n", [(256, 40), (1024, 16), (4096, 6)])
@pytest.mark.parametrize("ch", [3, 4])
@pytest.mark.parametrize("mode,nf", SEGMENT_SETTINGS)
def test_segment_encode_large_regions_equal_jax(p, n, ch, mode, nf):
    check_segment_encode_against_jax(p, n, ch, mode, nf)


def check_segment_encode_against_jax(p, n, ch, mode, nf):
    """The plain segment encode on ``_run_buffer(p, n, ch)`` against JAX's
    jnp composition: at most SEGMENT_FLIPS segments with an endpoint one
    apart, every other output equal."""
    words, mask, seg, blocks = _run_buffer(p, n, ch, seed=p + ch)
    jcfg = JConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode, num_factors=nf,
                   dithering=False)
    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode, num_factors=nf,
                       dithering=False)
    j_shifts, j_eps, j_avg, j_q, j_dec = _jax_segment_encode(words, mask, seg, jcfg)
    out = kc.segment_encode_reference(*(torch.from_numpy(a) for a in (words, mask, seg, blocks)),
                                      cfg, 0x5EED)
    eps = out.eps.numpy()
    flipped = np.unique(seg[(np.abs(eps - j_eps) > 0).any(axis=(0, 1))])
    assert flipped.size <= SEGMENT_FLIPS, f"segments with flipped endpoints: {flipped}"
    assert np.abs(eps - j_eps).max() <= 1
    ok = ~np.isin(seg, flipped)
    np.testing.assert_array_equal(out.shifts.numpy()[:, ok], j_shifts[:, ok])
    np.testing.assert_allclose(out.avg.numpy(), j_avg, rtol=1e-6, atol=1e-4)
    q = out.q.numpy()
    j_packed = j_q[0] | (j_q[1] << 8) | (j_q[2] << 16)
    np.testing.assert_array_equal(q[:, ok], j_packed[:, ok])
    dec = torch.stack([(out.dec >> (8 * c)) & 0xFF for c in range(ch)]).numpy()
    np.testing.assert_array_equal(dec[:, :, ok], j_dec[:, :, ok])
    members = mask.any(axis=0)
    np.testing.assert_array_equal(out.count_blk.numpy(), mask.sum(axis=0))
    assert (out.count_mem.numpy()[members] > 0).all()


@pytest.mark.parametrize("ch", [3, 4])
def test_saturated_region_needs_the_error_prescale(ch):
    """The 64x64 region of lane 0 errs 585225 (RGB) or 780300 (RGBA) on
    15/16 of its pixels once axis A is dropped (the ladder's sweep at shift
    8, which decodes every pixel to the black endpoint): its unscaled error
    sum
    passes 2^31, so the plain version pre-scales it as JAX does
    (``err_scale_shift`` 4 at P >= 2048), and both pick the same shifts."""
    words, mask, seg, blocks = _run_buffer(4096, 6, ch, seed=4096 + ch)
    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, dithering=False)
    w, m = torch.from_numpy(words), torch.from_numpy(mask)
    px = torch.stack([(w >> (8 * c)) & 0xFF for c in range(ch)])
    d, _ = fit_regions(px, m, ch, SegmentReducer(torch.from_numpy(seg)))
    f8 = torch.stack([f.to(torch.int32) for f in quantize_factors(*extract_factors(px, d, ch))])
    drop_a = torch.tensor([[8], [0], [0]], dtype=torch.int32).expand(3, 6)
    dec = decode_blocks(f8 >> torch.clamp(drop_a, max=8)[:, None, :], drop_a, d, ch)
    err = weighted_error(dec, px.to(torch.int32)) * m.to(torch.int32)
    assert int(err[:, 0].sum(dtype=torch.int64)) > 2**31
    out = kc.segment_encode_reference(w, m, torch.from_numpy(seg), torch.from_numpy(blocks),
                                      cfg, 0x5EED)
    jcfg = JConfig(error_factor=100, has_alpha=ch == 4, dithering=False)
    np.testing.assert_array_equal(out.shifts.numpy()[:, 0],
                                  _jax_segment_encode(words, mask, seg, jcfg)[0][:, 0])


# ---------------------------------------------------------------------------
# Dense encodes against the JAX fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    fx = np.load(rec.OUT)
    import json
    return fx, json.loads(str(fx["meta"]))


def _case_image(name: str) -> np.ndarray:
    if name in rec.SMALL_CASES:
        return rec.SMALL_CASES[name][0]()
    lane = rec.FULL_CASES[name][0]
    return mrec.make_4k_lane(*mrec.FULL, lane)


def _port_encode(name: str, meta: dict):
    m = meta["cases"][name]
    cfg = EncodeConfig(**m["config"])
    return cfg, limg_tpu_torch.encode_image_merged(
        _case_image(name), cfg, seed=0, num_levels=m["levels"], merge_policy=m["merge_policy"],
        coalesce=m["coalesce"], cap_frac=m["cap_frac"], rd_header_bits=m["rd_header_bits"],
        return_state=True, fused=False, device="cpu")


def _per_block_differences(out, state, fx, name: str) -> np.ndarray:
    """Blocks whose owner, shifts, bpp, region id, endpoints, run flag or
    factor / decoded block hashes differ from the fixture's."""
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
    return np.nonzero(diff)[0]


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_dense_encode_equals_jax_fixture(fixture, name):
    fx, meta = fixture
    cfg, (out, state) = _port_encode(name, meta)
    n_flips, n_owner = FLIPS[name]
    flipped = _per_block_differences(out, state, fx, name)
    assert flipped.size <= n_flips, f"{name}: blocks that differ: {flipped[:20]}"
    owner_flips = int((mrec.per_block(out["owner_px"]) != fx[f"{name}.owner"]).sum())
    assert owner_flips <= n_owner
    psnr_db, bpp = (MERGE_FLIP_PSNR_DB, MERGE_FLIP_BPP) if owner_flips else (PSNR_DB, BPP)
    assert abs(out["psnr"] - float(fx[f"{name}.psnr"])) <= psnr_db
    assert abs(out["mean_bpp"] - float(fx[f"{name}.mean_bpp"])) <= bpp
    # the counts move only with the flipped blocks: a merge flip moves one
    # region per level, and each flipped block at most its 64 pixels in
    # each axis's histogram
    np.testing.assert_allclose(out["alive_counts"], fx[f"{name}.alive_counts"],
                               atol=owner_flips // 4)
    hist_l1 = int(np.abs(out["bits_histogram"] - fx[f"{name}.bits_histogram"]).sum())
    assert hist_l1 <= 2 * 3 * 64 * flipped.size
    assert abs(out["n_runs"] - int(fx[f"{name}.n_runs"])) <= (flipped.size > 0)
    stats = np.asarray([out["coalesce_stats"].get(k, 0) for k in rec.STAT_KEYS])
    assert (np.abs(stats - fx[f"{name}.coalesce_stats"]) <= flipped.size).all()
    assert stats[0] == fx[f"{name}.coalesce_stats"][0]
    keys = meta["cases"][name]["merge_keys"]
    got = np.asarray([[s[k] for k in keys] for s in out["merge_stats"]]).reshape(-1, len(keys))
    np.testing.assert_allclose(got, fx[f"{name}.merge_stats"].reshape(-1, len(keys)),
                               rtol=1e-4, atol=owner_flips)
    assert state["q"].shape == (64, mrec.per_block(out["owner_px"]).size)


@pytest.mark.parametrize("name", list(rec.SMALL_CASES))
def test_dense_state_and_stream_equal_jax(fixture, name):
    """Where the port's serializer state is JAX's (the same SHA-256), its
    streams are JAX's, entropy on and off; it is JAX's in every case with
    no flipped block. The stream decodes to the encode."""
    fx, meta = fixture
    cfg, (out, state) = _port_encode(name, meta)
    same = rec.state_digest(state) == str(fx[f"{name}.state_sha256"])
    assert same or FLIPS[name][0] > 0
    for entropy, tag in ((True, "stream"), (False, "stream_raw")):
        blob = tb.serialize_from_state(state, cfg, entropy=entropy)
        if same:
            assert rec.stream_digest(blob) == str(fx[f"{name}.{tag}_sha256"])
            assert len(blob) == int(fx[f"{name}.{tag}_len"])
    dec, info = tb.deserialize(tb.serialize_from_state(state, cfg))
    np.testing.assert_array_equal(dec, out["decoded"])
    assert info["levels"] == meta["cases"][name]["levels"] and info["n_runs"] == out["n_runs"]
    if f"{name}.state_rows" in fx.files:
        np.testing.assert_array_equal(state["rows"], fx[f"{name}.state_rows"])
        np.testing.assert_array_equal(state["q"], fx[f"{name}.state_q"])
        jstate = dict(state, rows=fx[f"{name}.state_rows"], q=fx[f"{name}.state_q"])
        jcfg = JConfig(**meta["cases"][name]["config"])
        assert tb.serialize_from_state(state, cfg) == jb.serialize_from_state(jstate, jcfg)


def test_4k_fixture_is_complete(fixture):
    """The 4K cases chip_smoke.py phase 3g holds the card against."""
    fx, meta = fixture
    for name in rec.FULL_CASES:
        assert meta["cases"][name]["height"] == 2160
        assert fx[f"{name}.owner"].shape == (270 * 480,)
        assert fx[f"{name}.bits_histogram"].sum(axis=1).tolist() == [2160 * 3840] * 3
        assert fx[f"{name}.n_runs"] > 0 and len(str(fx[f"{name}.stream_sha256"])) == 64
    assert (fx["4k_rgb_l1.owner"] == 0).all()
    assert fx["4k_rgb_l3.alive_counts"].tolist()[0] == 129600


# ---------------------------------------------------------------------------
# Direct runs of the JAX dense path, and the path's dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels,policy,cap_frac", [(2, "match", 0), (3, "rd", -300)])
def test_dense_encode_equals_jax_run_directly(levels, policy, cap_frac):
    img = mrec.smoke_image()
    kw = dict(error_factor=100, has_alpha=True, dithering=False)
    jo, jstate = jregions.encode_image_merged(
        img, JConfig(**kw), num_levels=levels, use_pallas=False, fused=False,
        merge_policy=policy, cap_frac=cap_frac, return_state=True)
    out, state = limg_tpu_torch.encode_image_merged(
        img, EncodeConfig(**kw), num_levels=levels, fused=False, merge_policy=policy,
        cap_frac=cap_frac, return_state=True, device="cpu")
    for key in ("decoded", "factors", "shift", "bpp", "region_id", "owner_px",
                "endpoint_rows", "alive_counts", "bits_histogram"):
        np.testing.assert_array_equal(out[key], np.asarray(jo[key]), err_msg=key)
    assert abs(out["psnr"] - jo["psnr"]) <= PSNR_DB and abs(out["mean_bpp"] - jo["mean_bpp"]) <= BPP
    assert out["n_runs"] == jo["n_runs"] and out["coalesce_stats"] == jo["coalesce_stats"]
    np.testing.assert_array_equal(state["rows"], np.asarray(jstate["rows"]))
    np.testing.assert_array_equal(state["q"], np.asarray(jstate["q"]))


def test_fused_default_keeps_its_path_and_one_level_is_dense():
    """fused=None takes the fused path at 2-4 levels on the CPU, as before;
    num_levels=1 takes the dense path whatever fused says."""
    img = mrec.fused_band_image()
    cfg = EncodeConfig(error_factor=100, dithering=False)
    default = limg_tpu_torch.encode_image_merged(img, cfg, device="cpu")
    fused = limg_tpu_torch.encode_image_merged(img, cfg, fused=True, device="cpu")
    dense = limg_tpu_torch.encode_image_merged(img, cfg, fused=False, device="cpu")
    np.testing.assert_array_equal(default["decoded"], fused["decoded"])
    assert default["psnr"] == fused["psnr"] and default["n_runs"] == fused["n_runs"]
    # the dense path's merge test and coalescing differ from the fused path's
    assert default["alive_counts"].tolist() != dense["alive_counts"].tolist() or \
        default["n_runs"] != dense["n_runs"]
    one = [limg_tpu_torch.encode_image_merged(img, cfg, num_levels=1, fused=f, device="cpu")
           for f in (None, True, False)]
    for o in one[1:]:
        np.testing.assert_array_equal(o["decoded"], one[0]["decoded"])
    dev = limg_tpu_torch.encode_image_merged_device(img, cfg, num_levels=1, device="cpu")
    np.testing.assert_array_equal(dev["decoded"].numpy(), one[0]["decoded"])
    assert int(dev["n_runs"]) == one[0]["n_runs"]


def test_num_levels_five_raises_naming_its_item():
    """5 levels (ROADMAP.md Queue 1 item 16, landed) no longer raise: with
    fused None and False, and through the dense device entry point, the
    70x90 image's 5-level encode is the JAX package's recorded one
    (tests/fixtures/torch_port_levels_reference.npz: its serializer state
    bit for bit, its PSNR and bpp); the fused entry point still refuses 5
    levels, naming the dense path."""
    from tools import record_torch_levels_reference as lrec

    fx = np.load(lrec.OUT)
    name = "band70x90_rgb_l5"
    img = lrec.SMALL_CASES[name][0]()
    cfg = EncodeConfig(error_factor=100, dithering=False)
    for fused in (None, False):
        out, state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=5, fused=fused,
                                                        return_state=True, device="cpu")
        np.testing.assert_array_equal(state["rows"], fx[f"{name}.state_rows"])
        np.testing.assert_array_equal(state["q"], fx[f"{name}.state_q"])
        assert abs(out["psnr"] - float(fx[f"{name}.psnr"])) <= PSNR_DB
        assert abs(out["mean_bpp"] - float(fx[f"{name}.mean_bpp"])) <= BPP
    dev = limg_tpu_torch.encode_image_merged_device(img, cfg, num_levels=5, device="cpu")
    np.testing.assert_array_equal(dev["decoded"].numpy(), out["decoded"])
    assert dev["alive_counts"].tolist() == fx[f"{name}.alive_counts"].tolist()
    with pytest.raises(ValueError, match="dense path"):
        limg_tpu_torch.encode_image_merged_fused_device(img, cfg, num_levels=5, device="cpu")
