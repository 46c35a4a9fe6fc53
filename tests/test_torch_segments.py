"""limg_tpu_torch's segment reductions and segment re-encode vs the JAX
package, on the CPU.

- The doubling-scan chain (ops/segments.py ``seg_mixed_all``) must be
  bit-equal to JAX's ``seg_mixed_all_jnp`` for int32 and float32 rows and
  any mix of sum and max rows: both add in the same order; and so must the
  batched scan (kernels/coalesce.py ``seg_scan``) on every problem of a
  batch, column problems included.
- The plain segment re-encode (kernels/coalesce.py
  ``segment_encode_reference``) against JAX's jnp composition
  (``fit_segments`` + ``find_shifts_segments`` + decode, contiguous mode,
  dithering off): shifts, endpoints and decoded pixels equal, except on
  segments where a float sum taken in another order moved a rounded
  endpoint by 1 (counted, and bounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops import segments as jseg
from limg_tpu.ops.decode import decode_blocks as j_decode
from limg_tpu.ops.error import weighted_error as j_weighted_error
from limg_tpu.ops.factors import extract_factors as j_extract
from limg_tpu.ops.factors import quantize_factors as j_quantize
from limg_tpu.ops.fit import drop_decomposition_axes as j_drop

from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import coalesce as kc
from limg_tpu_torch.ops import segments
from limg_tpu_torch.ops.crush import find_shifts
from limg_tpu_torch.ops.dither import coalesce_key, dither_crush_key, dither_key
from limg_tpu_torch.ops.fit import Decomposition, fit_regions
from limg_tpu_torch.ops.reduce import SegmentReducer
from limg_tpu_torch.regions import compact_runs
from chip_smoke import seeded_run_buffer, seg_map
from tools.record_torch_merged_reference import make_4k_lane

torch.set_num_threads(1)

_J_CHAIN = jax.jit(jseg.seg_mixed_all_jnp, static_argnums=(2,))


# ---------------------------------------------------------------------------
# The scan chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 300, 5000])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n_sum", [0, 2, 3])
def test_seg_mixed_all_bit_equal_jax(n, dtype, n_sum):
    rng = np.random.default_rng(n * 7 + n_sum)
    seg = seg_map(rng, n)
    if dtype == "int32":
        x = rng.integers(-2**20, 2**20, (3, n)).astype(np.int32)
        init = -2**20
    else:
        x = (rng.standard_normal((3, n)) * 10.0 ** rng.integers(-3, 4, (3, n))).astype(np.float32)
        init = -3.4e38
    want = np.asarray(_J_CHAIN(jnp.asarray(x), jnp.asarray(seg), n_sum, init))
    got = segments.seg_mixed_all(torch.from_numpy(x), torch.from_numpy(seg), n_sum, init)
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel wrapper runs the same plain version on a CPU tensor
    np.testing.assert_array_equal(
        kc.seg_mixed_all_kernel(torch.from_numpy(x), torch.from_numpy(seg), n_sum, init).numpy(),
        want)


def test_seg_sum_and_min_are_exact_for_integers():
    rng = np.random.default_rng(5)
    n = 2000
    seg = seg_map(rng, n)
    x = rng.integers(0, 2, n).astype(np.int32)
    t_seg, t_x = torch.from_numpy(seg), torch.from_numpy(x)
    sums, mins = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for s in np.unique(seg):
        members = seg == s
        sums[members], mins[members] = x[members].sum(), x[members].min()
    np.testing.assert_array_equal(kc.seg_sum_all(t_x, t_seg).numpy(), sums)
    np.testing.assert_array_equal(kc.seg_min_all(t_x, t_seg, 1).numpy(), mins)
    np.testing.assert_array_equal(kc.seg_min_all(t_x, t_seg, 1).numpy(),
                                  np.asarray(jseg.seg_min_all(jnp.asarray(x), jnp.asarray(seg), 1)))
    assert segments.scan_steps(1) == [] and segments.scan_steps(300) == [1, 2, 4, 8, 16, 32, 64, 128]
    assert (segments.SEG_CAP, segments.SEG_ERR_SHIFT) == (jseg.SEG_CAP, jseg.SEG_ERR_SHIFT)


def test_segment_reducer_reduces_each_segment():
    rng = np.random.default_rng(9)
    n = 700
    seg = torch.from_numpy(seg_map(rng, n, 40))
    red = SegmentReducer(seg)
    x = torch.from_numpy(rng.normal(0, 100, (2, 64, n)).astype(np.float32))
    blk = x[:, :32] + x[:, 32:]
    for k in (16, 8, 4, 2, 1):
        blk = blk[:, :k] + blk[:, k:2 * k]
    assert torch.equal(red.sum(x), segments.seg_mixed_all(blk[:, 0], seg, 2))
    assert torch.equal(red.min(x), -segments.seg_mixed_all(-x.amin(dim=-2), seg, 0))
    assert torch.equal(red.max(x), segments.seg_mixed_all(x.amax(dim=-2), seg, 0))
    assert red.chunks == 1 and red.seg_err_shift == segments.SEG_ERR_SHIFT


# ---------------------------------------------------------------------------
# The batched scan (kernels/coalesce.py seg_scan)
# ---------------------------------------------------------------------------

BATCH_SIZES = (1, 7, 255, 256, 257, 5000)


def _batch(rng, dtype: str):
    """One problem per size: segments up to 400 lanes (over SEG_CAP, where a
    lane sees only part of its segment), int32 rows with a row of ones or
    float32 rows over many magnitudes, sum / max / min mixes."""
    probs = []
    for i, n in enumerate(BATCH_SIZES):
        seg = torch.from_numpy(seg_map(rng, n, (400, 16, 256)[i % 3]))
        if dtype == "int32":
            rows = [None, torch.from_numpy(rng.integers(-2**20, 2**20, n).astype(np.int32)),
                    torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))]
            ops = ("sxn", "nsx", "xns")[i % 3]
            init = -2**20
        else:
            rows = [torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
                                     .astype(np.float32)) for _ in range(3)]
            ops = ("sxn", "ssn", "xxs")[i % 3]
            init = -3.4e38
        probs.append(kc.ScanProblem(seg, rows, ops, init))
    return probs


def _jax_rows(p, rows):
    """The problem's rows as JAX's seg_mixed_all_jnp computes them, one call
    per kind of row (sums and maxima; minima as -max(-x))."""
    seg = jnp.asarray(p.seg.numpy())
    out = []
    for row, op in zip(rows, p.ops):
        x = jnp.asarray(row)[None]
        if op == "n":
            out.append(-np.asarray(_J_CHAIN(-x, seg, 0, -p.init))[0])
        else:
            out.append(np.asarray(_J_CHAIN(x, seg, int(op == "s"), p.init))[0])
    return np.stack(out)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_batched_scan_is_one_plain_chain_per_problem_and_jax(dtype):
    rng = np.random.default_rng(len(dtype))
    probs = _batch(rng, dtype)
    got = kc.seg_scan(probs)                           # the plain version on the CPU
    assert len(got) == len(probs)
    for p, g in zip(probs, got):
        n = p.seg.numel()
        rows = [np.ones(n, np.int32) if r is None else r.numpy() for r in p.rows]
        x = torch.from_numpy(np.stack(rows))
        # one plain chain on the whole problem: sums and maxima in one call,
        # minima as -max(-x) in another
        plain = np.empty_like(rows)
        sx = [i for i, o in enumerate(p.ops) if o != "n"]
        n_sum = sum(o == "s" for o in p.ops)
        order = sorted(sx, key=lambda i: p.ops[i] != "s")
        if order:
            plain[order] = segments.seg_mixed_all(x[order], p.seg, n_sum, p.init).numpy()
        mins = [i for i, o in enumerate(p.ops) if o == "n"]
        if mins:
            plain[mins] = (-segments.seg_mixed_all(-x[mins], p.seg, 0, -p.init)).numpy()
        assert g.dtype == x.dtype and g.shape == (len(rows), n)
        np.testing.assert_array_equal(g.numpy(), plain)
        np.testing.assert_array_equal(g.numpy(), _jax_rows(p, rows))


def test_batched_scan_columns_are_the_transposed_scan():
    """A column problem scans a (gy, gx) map down its columns in place: the
    plain chain over the transposed map, results in the map's layout, and
    JAX's on the transposed copy; ids are only compared, so row-major
    indices do as well as positions in the column order."""
    rng = np.random.default_rng(3)
    gy, gx = 37, 61
    seg_t = seg_map(rng, gy * gx, 20).reshape(gx, gy)           # runs down each column
    ids = (seg_t % gy) * gx + seg_t // gy                       # the same runs, row-major ids
    x = rng.integers(0, 2, (gy, gx)).astype(np.int32)
    (got,) = kc.seg_scan([kc.ScanProblem(torch.from_numpy(ids.T.copy()),
                                         [None, torch.from_numpy(x)], "sn", 1, columns=True)])
    col_seg = jnp.asarray(seg_t.reshape(-1))
    ones = jnp.ones((1, gy * gx), jnp.int32)
    want_len = np.asarray(_J_CHAIN(ones, col_seg, 1, 0))[0].reshape(gx, gy).T
    want_min = -np.asarray(_J_CHAIN(-jnp.asarray(x.T.reshape(1, -1)), col_seg, 0, -1))[0]
    np.testing.assert_array_equal(got[0].numpy(), want_len)
    np.testing.assert_array_equal(got[1].numpy(), want_min.reshape(gx, gy).T)


def test_batched_scan_is_exact_for_any_ids():
    """Lanes outside a problem carry the plain version's fills (id -1 left,
    -2 right), so ids that equal them, or repeat out of order, scan as in
    one plain chain; other labels of the same runs scan as their first
    positions do; and more rows or problems than one launch takes split into
    more launches with the same results."""
    from chip_smoke import run_labels

    rng = np.random.default_rng(4)
    probs = []
    for n in (1, 3, 40, 600):
        seg = torch.from_numpy(rng.integers(-3, 3, n).astype(np.int32))
        rows = [torch.from_numpy(rng.integers(-50, 50, n).astype(np.int32)) for _ in range(6)]
        probs.append(kc.ScanProblem(seg, rows, "sxnsxn", 5))
    probs += probs[:1] * (kc.SCAN_MAX_PROBLEMS + 1)
    for p, g in zip(probs, kc.seg_scan(probs)):
        for row, op, out in zip(p.rows, p.ops, g):
            if op == "n":
                want = -segments.seg_mixed_all(-row[None], p.seg, 0, -5)[0]
            else:
                want = segments.seg_mixed_all(row[None], p.seg, int(op == "s"), 5)[0]
            assert torch.equal(out, want)
    first = seg_map(rng, 900, 300)
    x = torch.from_numpy(rng.standard_normal((2, 900)).astype(np.float32))
    labelled, firsts = (kc.seg_scan([kc.ScanProblem(torch.from_numpy(s), list(x), "sx", -1.0)])[0]
                        for s in (run_labels(rng, first), first))
    assert torch.equal(labelled, firsts)


def test_seg_scan_checks_its_problems():
    seg = torch.zeros(5, dtype=torch.int32)
    x = torch.zeros(5, dtype=torch.int32)
    bad = [kc.ScanProblem(seg.long(), [x], "s"),                      # int64 ids
           kc.ScanProblem(seg, [x], "sx"),                             # an op too many
           kc.ScanProblem(seg, [x], "m"),                              # no such op
           kc.ScanProblem(seg, [x, x.float()], "ss"),                  # mixed dtypes
           kc.ScanProblem(seg, [x[:4]], "s"),                          # a short row
           kc.ScanProblem(seg, [x], "s", columns=True)]                # a column problem needs a map
    for p in bad:
        with pytest.raises(ValueError):
            kc.seg_scan([p])
    with pytest.raises(RuntimeError, match="no kernel"):
        kc.seg_scan([kc.ScanProblem(seg.to("meta"), [x.to("meta")], "s")])


# ---------------------------------------------------------------------------
# The segment re-encode
# ---------------------------------------------------------------------------

def _image_buffer(lane):
    """A real compacted run buffer: make_4k(256, 384)'s run blocks, sorted
    by segment, as the coalesce pass builds it (plus its tail of non-run
    blocks, which carry a zero mask)."""
    import limg_tpu_torch

    img = make_4k_lane(256, 384, lane)
    cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False)
    state = limg_tpu_torch.fused_merged_pre(img, cfg, num_levels=3, device="cpu")
    order, seg_c = compact_runs(state["seg0"], state["is_run0"], state["seg0"].numel())
    mask = state["mask"][:, order] & state["is_run0"][order][None]
    return state["px"][:, order], mask, seg_c, order.to(torch.int32)


def _random_buffer(rng, n, channels):
    """chip_smoke.py's seeded run buffer (tests/test_segment_kernel.py's
    recipe: half the segments smooth, some empty and half-empty blocks)."""
    return seeded_run_buffer(rng, n, channels, "cpu")


def _jax_segment_encode(packed, mask, seg, cfg):
    """tests/test_segment_kernel.py's jnp composition of the re-encode."""
    ch = cfg.channels
    n = packed.shape[1]
    p = packed.numpy().astype(np.int64) & 0xFFFFFFFF
    px = jnp.asarray(np.stack([(p >> (8 * c)) & 0xFF for c in range(ch)]).astype(np.int32))
    m, s = jnp.asarray(mask.numpy()), jnp.asarray(seg.numpy())
    d = jseg.fit_segments(px, m, s, n, ch, contiguous=True)
    if cfg.num_factors < 3:
        d = j_drop(d, cfg.num_factors)
    f8_u8 = j_quantize(*j_extract(px, d, ch))
    shifts, _ = jseg.find_shifts_segments(px, m, f8_u8, d, s, n, cfg, contiguous=True)
    if cfg.num_factors < 3:
        forced = jnp.asarray([0] * cfg.num_factors + [8] * (3 - cfg.num_factors), jnp.int32)
        shifts = jnp.maximum(shifts, forced[:, None])
    q = jnp.stack([f.astype(jnp.int32) for f in f8_u8]) >> jnp.minimum(shifts, 8)[:, None, :]
    dec = j_decode(q, shifts, d, ch)
    dist = (j_weighted_error(dec, px) * m.astype(jnp.int32)).astype(jnp.float32).sum(axis=0)
    return d, np.asarray(shifts), np.asarray(dec), np.asarray(dist)


def _compare_segment_encode(packed, mask, seg, blocks, overrides):
    """Port vs JAX on one buffer. Returns (flipped segments, segments)."""
    kw = dict(error_factor=100, dithering=False, crush_mode="ladder")
    kw.update(overrides)
    cfg = EncodeConfig(**kw)
    ch = cfg.channels
    got = kc.segment_encode_reference(packed, mask, seg, blocks, cfg, 0)
    d, shifts, dec, dist = _jax_segment_encode(packed, mask, seg, JConfig(**kw))
    ep_j = np.stack([np.asarray(f) for f in d[1:]]).astype(np.int64)     # (6, ch, N)
    ep_t = got.eps.numpy().astype(np.int64)
    dec_t = np.stack([(got.dec.numpy() >> (8 * c)) & 0xFF for c in range(ch)])
    m = mask.numpy()
    bad = ((np.abs(ep_t - ep_j).max(axis=(0, 1)) > 0)
           | (got.shifts.numpy() != shifts).any(axis=0)
           | (np.where(m, dec_t, 0) != np.where(m, dec, 0)).any(axis=(0, 1))
           | (np.abs(got.dist_blk.numpy() - dist) > 1e-6 * np.maximum(dist, 1.0)))
    seg_np = seg.numpy()
    flipped = np.unique(seg_np[bad])
    # a mismatch is explained only by a +-1 endpoint somewhere in its segment
    ep_flip = np.abs(ep_t - ep_j).max(axis=(0, 1))
    for s in flipped:
        members = seg_np == s
        assert ep_flip[members].max() == 1, f"segment {s} differs without a +-1 endpoint flip"
    # counts, the member broadcast and the avg are exact
    np.testing.assert_array_equal(got.count_blk.numpy(), m.sum(axis=0))
    np.testing.assert_array_equal(got.avg.numpy(), np.asarray(d.avg))
    assert got.q.shape == got.dec.shape == packed.shape
    return len(flipped), len(np.unique(seg_np))


@pytest.mark.parametrize("overrides", [
    {}, {"crush_mode": "guess"}, {"num_factors": 2}, {"num_factors": 1},
    {"has_alpha": True}, {"crush_mode": "none"},
])
def test_segment_encode_matches_jax_on_random_buffers(overrides):
    rng = np.random.default_rng(len(str(overrides)))
    ch = 4 if overrides.get("has_alpha") else 3
    flips, n_seg = _compare_segment_encode(*_random_buffer(rng, 600, ch), overrides)
    print(f"{overrides}: {flips} flipped segments of {n_seg}")
    assert flips <= max(1, n_seg // 100)


@pytest.mark.parametrize("lane", ["rgb", "rgba"])
def test_segment_encode_matches_jax_on_a_real_run_buffer(lane):
    packed, mask, seg, blocks = _image_buffer(lane)
    flips, n_seg = _compare_segment_encode(packed, mask, seg, blocks,
                                           {"has_alpha": lane == "rgba"})
    print(f"{lane}: {flips} flipped segments of {n_seg}")
    assert flips <= max(1, n_seg // 100)


def test_segment_fit_of_singletons_is_the_block_fit():
    """fit_regions with a SegmentReducer over singleton segments is the
    fixed-grid fit of each block."""
    from limg_tpu_torch.ops.fit import fit_blocks
    from limg_tpu_torch.ops.layout import unpack_plane

    packed, mask, _, _ = _random_buffer(np.random.default_rng(3), 200, 3)
    px = torch.stack([unpack_plane(packed, c) for c in range(3)])
    d_seg, count = fit_regions(px, mask, 3, SegmentReducer(torch.arange(200, dtype=torch.int32)))
    for a, b in zip(d_seg, fit_blocks(px, mask, 3)):
        assert torch.equal(a, b)
    assert torch.equal(count, mask.sum(dim=0, dtype=torch.int32))


@pytest.mark.parametrize("overrides", [{}, {"crush_mode": "exhaustive"}, {"crush_mode": "guess"},
                                       {"num_factors": 2}])
def test_segment_crush_equals_jax_on_jax_fit(overrides):
    """find_shifts with a SegmentReducer is JAX's find_shifts_segments
    (contiguous mode) bit for bit when both start from JAX's own fit: the
    crush is integer arithmetic, with SEG_ERR_SHIFT and float admissibility."""
    from limg_tpu_torch.ops.layout import unpack_plane

    kw = dict(error_factor=100, dithering=False, **overrides)
    cfg, jcfg = EncodeConfig(**kw), JConfig(**kw)
    rng = np.random.default_rng(11)
    n = 300 if overrides.get("crush_mode") == "exhaustive" else 600
    packed, mask, seg, _ = _random_buffer(rng, n, 3)
    px = torch.stack([unpack_plane(packed, c) for c in range(3)])
    jpx, jm, js = jnp.asarray(px.numpy()), jnp.asarray(mask.numpy()), jnp.asarray(seg.numpy())
    d = jseg.fit_segments(jpx, jm, js, n, 3, contiguous=True)
    if cfg.num_factors < 3:
        d = j_drop(d, cfg.num_factors)
    f8 = j_quantize(*j_extract(jpx, d, 3))
    want, _ = jseg.find_shifts_segments(jpx, jm, f8, d, js, n, jcfg, contiguous=True)
    d_t = Decomposition(*(torch.from_numpy(np.array(f)) for f in d))
    d_t = d_t._replace(**{f: getattr(d_t, f).to(torch.int32) for f in d_t._fields[1:]})
    f8_t = torch.stack([torch.from_numpy(np.asarray(f).astype(np.int32)) for f in f8])
    got, _ = find_shifts(px, mask, f8_t, d_t, cfg, SegmentReducer(seg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_coalesce_dither_key_and_block_counter():
    """The coalesce pass draws its own noise, keyed by each lane's image
    block index, so a block's noise does not depend on its buffer slot."""
    assert coalesce_key(0, 7) != dither_key(0, 7)
    assert coalesce_key(0, 7) == coalesce_key(0, 7) != coalesce_key(1, 7)
    f8 = torch.randint(0, 256, (3, 64, 5), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    shifts = torch.full((3, 5), 3, dtype=torch.int32)
    blocks = torch.tensor([40, 7, 19, 3, 11], dtype=torch.int32)
    q = dither_crush_key(f8, shifts, 1234, blocks=blocks)
    perm = torch.tensor([3, 0, 4, 1, 2])
    q_perm = dither_crush_key(f8[..., perm], shifts, 1234, blocks=blocks[perm])
    assert torch.equal(q[..., perm], q_perm)
    assert not torch.equal(q, dither_crush_key(f8, shifts, 1235, blocks=blocks))


def test_segment_encode_wrapper_checks_inputs():
    rng = np.random.default_rng(1)
    packed, mask, seg, blocks = _random_buffer(rng, 40, 3)
    cfg = EncodeConfig()
    with pytest.raises(ValueError):
        kc.segment_encode_kernel(packed[:32], mask[:32], seg, blocks, cfg, 0)
    with pytest.raises(ValueError):
        kc.segment_encode_kernel(packed, mask.to(torch.int32), seg, blocks, cfg, 0)
    with pytest.raises(ValueError):
        kc.segment_encode_kernel(packed, mask, seg.to(torch.int64), blocks, cfg, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        kc.segment_encode_kernel(packed.to("meta"), mask.to("meta"), seg.to("meta"),
                                 blocks.to("meta"), cfg, 0)
    out = kc.segment_encode_kernel(packed, mask, seg, blocks, cfg, 0, emit_q=False)
    assert out.q is None and out.dec.shape == (64, 40) and out.eps.shape == (6, 3, 40)
    assert isinstance(out.avg, torch.Tensor) and Decomposition._fields[0] == "avg"
