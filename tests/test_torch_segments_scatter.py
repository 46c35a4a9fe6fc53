"""limg_tpu_torch's scatter-form segment reductions, refit and crush vs the
JAX package, on the CPU.

The scatter form takes any segment map: ids in [0, S), members anywhere,
per-segment results (..., S) (limg_tpu/ops/segments.py ``seg_sum`` :44,
``seg_max`` / ``seg_min`` :222-230, ``gather_decomp`` :232, and
``fit_segments`` / ``find_shifts_segments`` with ``contiguous=False``).
Maps: seeded random ids with empty segments and ``num_segments`` above the
largest id, singletons (tests/test_regions.py:274-305), and quadtree owner
squares numbered in row-major block order (chip_smoke.py
``owner_segment_map``), on two image shapes.

- ``seg_sum`` of float rows equals JAX's scatter-add bit for bit: both are
  left folds over a segment's members in block order, from 0.0.
  ``seg_max`` / ``seg_min`` and integer sums are exact in any order.
- ``find_shifts_segments`` from JAX's own fit gives JAX's shifts and block
  errors exactly (integer arithmetic, SEG_ERR_SHIFT, float admissibility);
  a segment with no member gives (0, 0, 0) and 2^31 - 1.
- ``fit_segments`` gives JAX's endpoints except where a block's float sum,
  taken in another order (the port's halving tree against XLA's), moves a
  rounded endpoint by 1: such flips are counted and bounded; empty
  segments are all zeros in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops import crush as jcrush
from limg_tpu.ops import segments as jseg
from limg_tpu.ops.factors import extract_factors as j_extract
from limg_tpu.ops.factors import quantize_factors as j_quantize
from limg_tpu.ops.fit import drop_decomposition_axes as j_drop

from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import seg_fold
from limg_tpu_torch.ops import crush, layout, segments
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS, Decomposition
from chip_smoke import owner_segment_map, seg_map
from tools.record_torch_merged_reference import make_4k_lane

torch.set_num_threads(1)

# (h, w): an aligned grid of 8 x 12 blocks, and a ragged one of 6 x 9 whose
# last row and column are part-masked
SHAPES = {"aligned": (64, 96), "ragged": (45, 67)}
MAPS = ("random", "singletons", "squares")


def _blocks(shape: str, lane: str):
    h, w = SHAPES[shape]
    img = make_4k_lane(h, w, lane)
    px, mask, grid = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)))
    return px, mask, grid


def _segment_map(kind: str, grid, seed: int = 0):
    """(seg_id (NB,) int32, num_segments)."""
    rng = np.random.default_rng(seed)
    nb = grid.num_blocks
    if kind == "singletons":
        return np.arange(nb, dtype=np.int32), nb
    if kind == "random":
        # ids below S - 3: the last three segments and some others are empty
        s = nb // 3 + 3
        return rng.integers(0, s - 3, nb).astype(np.int32), s
    # quadtree owners: each aligned 2x2 square of level 0 or 1, each aligned
    # 4x4 one of level 2 one time in three
    by, bx = grid.blocks_y, grid.blocks_x
    owner = np.repeat(np.repeat(rng.integers(0, 2, (-(-by // 2), -(-bx // 2))), 2, 0), 2, 1)
    top = np.repeat(np.repeat(rng.integers(0, 3, (-(-by // 4), -(-bx // 4))) == 0, 4, 0), 4, 1)
    owner = np.where(top[:by, :bx], 2, owner[:by, :bx])
    return owner_segment_map(owner)


def _jnp(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _to_torch_decomp(d) -> Decomposition:
    d = Decomposition(*(torch.from_numpy(np.array(f)) for f in d))
    return d._replace(**{f: getattr(d, f).to(torch.int32) for f in ENDPOINT_FIELDS})


# ---------------------------------------------------------------------------
# The reductions
# ---------------------------------------------------------------------------

def _rows(rng, dtype: str, n: int) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-2**20, 2**20, (3, n)).astype(np.int32)
    # magnitudes over seven decades, so the order of a sum shows in its bits
    return (rng.standard_normal((3, n)) * 10.0 ** rng.integers(-3, 4, (3, n))).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n,s", [(20000, 300), (5000, 5000), (37, 50)])
def test_seg_reductions_equal_jax(dtype, n, s):
    rng = np.random.default_rng(n + s)
    x = _rows(rng, dtype, n)
    seg = rng.integers(0, max(1, s - 7), n).astype(np.int32)   # some segments empty
    t_x, t_seg = torch.from_numpy(x), torch.from_numpy(seg)
    init = -2**20 if dtype == "int32" else -3.4e38
    np.testing.assert_array_equal(segments.seg_sum(t_x, t_seg, s).numpy(),
                                  np.asarray(jseg.seg_sum(_jnp(x), _jnp(seg), s)))
    np.testing.assert_array_equal(segments.seg_max(t_x, t_seg, s, init).numpy(),
                                  np.asarray(jseg.seg_max(_jnp(x), _jnp(seg), s, init)))
    np.testing.assert_array_equal(segments.seg_min(t_x, t_seg, s, -init).numpy(),
                                  np.asarray(jseg.seg_min(_jnp(x), _jnp(seg), s, -init)))
    # a float sum is a left fold from 0.0, as numpy's unbuffered add.at
    if dtype == "float32":
        want = np.zeros((3, s), np.float32)
        for r in range(3):
            np.add.at(want[r], seg, x[r])
        np.testing.assert_array_equal(segments.seg_sum(t_x, t_seg, s).numpy(), want)


@pytest.mark.parametrize("kind", MAPS)
def test_seg_sum_on_block_maps_and_gather_decomp_equal_jax(kind):
    px, mask, grid = _blocks("ragged", "rgb")
    seg, s = _segment_map(kind, grid, 1)
    rows = (px.to(torch.float32) * 1.37 - 100.0).sum(dim=1) / 7.0     # (3, NB)
    np.testing.assert_array_equal(segments.seg_sum(rows, torch.from_numpy(seg), s).numpy(),
                                  np.asarray(jseg.seg_sum(_jnp(rows), _jnp(seg), s)))
    rng = np.random.default_rng(2)
    d = Decomposition(torch.from_numpy(rng.normal(0, 50, (3, s)).astype(np.float32)),
                      *(torch.from_numpy(rng.integers(-255, 256, (3, s)).astype(np.int32))
                        for _ in ENDPOINT_FIELDS))
    got = segments.gather_decomp(d, torch.from_numpy(seg))
    want = jseg.gather_decomp(jseg.Decomposition(*(_jnp(f) for f in d)), _jnp(seg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [7, 300, 3000])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_contiguous_reductions_equal_jax(n, dtype):
    rng = np.random.default_rng(n)
    seg = seg_map(rng, n)
    x = _rows(rng, dtype, n)
    t_x, t_seg, j_x, j_seg = torch.from_numpy(x), torch.from_numpy(seg), _jnp(x), _jnp(seg)
    init = -2**20 if dtype == "int32" else -3.4e38
    pairs = [
        (segments.seg_sum_all(t_x, t_seg), jseg.seg_sum_all(j_x, j_seg)),
        (segments.seg_max_all(t_x, t_seg, init), jseg.seg_max_all(j_x, j_seg, init)),
        (segments.seg_min_all(t_x, t_seg, -init), jseg.seg_min_all(j_x, j_seg, -init)),
        (segments.seg_sum_contig(t_x, t_seg, n), jseg.seg_sum_contig(j_x, j_seg, n)),
        (segments.seg_max_contig(t_x, t_seg, n, init), jseg.seg_max_contig(j_x, j_seg, n, init)),
        (segments.seg_min_contig(t_x, t_seg, n, -init),
         jseg.seg_min_contig(j_x, j_seg, n, -init)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="num_segments"):
        segments.seg_sum_contig(t_x, t_seg, n + 1)


def test_fold_plan_and_wrapper():
    """The kernel's plan lists each segment's members in block order; the
    wrapper takes the plain version on a CPU tensor and checks its inputs."""
    seg = torch.tensor([3, 0, 3, 1, 0, 3], dtype=torch.int32)
    plan = segments.fold_plan(seg, 5)
    assert plan.order.tolist() == [1, 4, 3, 0, 2, 5]
    assert plan.starts.tolist() == [0, 2, 3, 3, 6, 6]
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6) / 3.0
    got = seg_fold.seg_sum_fold_kernel(x, seg, 5, plan)
    assert torch.equal(got, segments.seg_sum_plain(x, seg, 5))
    assert torch.equal(got[:, 2], torch.zeros(2)) and got.shape == (2, 5)
    with pytest.raises(ValueError, match="float32"):
        seg_fold.seg_sum_fold_kernel(x.to(torch.float64), seg, 5)
    with pytest.raises(ValueError, match="plan.starts"):
        seg_fold.seg_sum_fold_kernel(x, seg, 5, plan._replace(starts=plan.starts[:-1]))
    with pytest.raises(RuntimeError, match="no kernel"):
        seg_fold.seg_sum_fold_kernel(x.to("meta"), seg.to("meta"), 5)


# ---------------------------------------------------------------------------
# The refit and the crush
# ---------------------------------------------------------------------------

def _jax_fit(px, mask, seg, s, ch, contiguous=False):
    return jseg.fit_segments(_jnp(px), _jnp(mask), _jnp(seg), s, ch, contiguous=contiguous)


@pytest.mark.parametrize("kind", MAPS)
@pytest.mark.parametrize("shape,lane", [("aligned", "rgb"), ("ragged", "rgba")])
def test_fit_segments_equals_jax(kind, shape, lane):
    px, mask, grid = _blocks(shape, lane)
    ch = px.shape[0]
    seg, s = _segment_map(kind, grid)
    got = segments.fit_segments(px, mask, torch.from_numpy(seg), s, ch)
    want = _jax_fit(px, mask, seg, s, ch)
    assert all(f.shape == (ch, s) for f in got)
    ep_got = np.stack([getattr(got, f).numpy() for f in ENDPOINT_FIELDS])
    ep_want = np.stack([np.asarray(getattr(want, f)) for f in ENDPOINT_FIELDS]).astype(np.int64)
    diff = np.abs(ep_got - ep_want).max(axis=(0, 1))                     # (S,)
    flips = int((diff > 0).sum())
    print(f"{kind} {shape} {lane}: {flips} of {s} segments with a +-1 endpoint flip")
    assert diff.max() <= 1 and flips <= max(1, s // 20)
    np.testing.assert_allclose(got.avg.numpy(), np.asarray(want.avg), rtol=1e-5, atol=1e-4)
    empty = np.bincount(seg, minlength=s) == 0
    assert kind != "random" or empty.sum() >= 3
    for f in got:
        assert not f[:, torch.from_numpy(empty)].any()


# (map, shape, lane, config overrides): every mode on the random map, whose
# empty segments each mode must give (0, 0, 0) / 2^31 - 1, num_factors 1-3,
# RGB and RGBA, and no crush
CRUSH_CASES = [
    ("random", "aligned", "rgb", {}),
    ("random", "aligned", "rgb", {"crush_mode": "exhaustive"}),
    ("random", "aligned", "rgb", {"crush_mode": "guess"}),
    ("random", "ragged", "rgba", {"num_factors": 2}),
    ("random", "ragged", "rgba", {"crush_mode": "exhaustive", "num_factors": 1}),
    ("random", "ragged", "rgba", {"crush_mode": "guess", "num_factors": 2}),
    ("singletons", "ragged", "rgb", {}),
    ("singletons", "aligned", "rgba", {"crush_mode": "guess", "num_factors": 1}),
    ("squares", "aligned", "rgb", {"num_factors": 1}),
    ("squares", "aligned", "rgba", {"crush_mode": "exhaustive"}),
    ("squares", "ragged", "rgb", {"crush_mode": "guess"}),
    ("squares", "ragged", "rgba", {}),
    ("squares", "aligned", "rgb", {"crush_mode": "none"}),
]


@pytest.mark.parametrize("kind,shape,lane,overrides", CRUSH_CASES)
def test_find_shifts_segments_equals_jax_on_jax_fit(kind, shape, lane, overrides):
    px, mask, grid = _blocks(shape, lane)
    ch = px.shape[0]
    kw = dict(error_factor=100, has_alpha=ch == 4, **overrides)
    cfg, jcfg = EncodeConfig(**kw), JConfig(**kw)
    seg, s = _segment_map(kind, grid)
    d = _jax_fit(px, mask, seg, s, ch)
    if cfg.num_factors < 3:
        d = j_drop(d, cfg.num_factors)
    f8 = j_quantize(*j_extract(_jnp(px), jseg.gather_decomp(d, _jnp(seg)), ch))
    want = jseg.find_shifts_segments(_jnp(px), _jnp(mask), f8, d, _jnp(seg), s, jcfg)
    f8_t = torch.stack([torch.from_numpy(np.asarray(f).astype(np.int32)) for f in f8])
    got = segments.find_shifts_segments(px, mask, f8_t, _to_torch_decomp(d),
                                        torch.from_numpy(seg), s, cfg)
    assert got[0].shape == (3, s) and got[1].shape == (s,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    empty = np.bincount(seg, minlength=s) == 0
    if cfg.crush_bits:
        assert (got[0].numpy()[:, empty] == 0).all()
        assert (got[1].numpy()[empty] == 2**31 - 1).all()
        assert (got[0].numpy() > 0).any(), "no segment crushed: the case tests nothing"


@pytest.mark.parametrize("kind,lane,mode", [("squares", "rgb", "ladder"),
                                            ("random", "rgba", "guess")])
def test_scatter_fit_and_crush_end_to_end(kind, lane, mode):
    """The port's own fit, factors and crush against JAX's: equal wherever no
    endpoint flipped; a segment that differs holds a +-1 endpoint flip."""
    px, mask, grid = _blocks("aligned", lane)
    ch = px.shape[0]
    kw = dict(error_factor=100, has_alpha=ch == 4, crush_mode=mode)
    seg, s = _segment_map(kind, grid, 3)
    t_seg = torch.from_numpy(seg)
    d_t = segments.fit_segments(px, mask, t_seg, s, ch)
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors

    f8_t = torch.stack([q.to(torch.int32) for q in quantize_factors(
        *extract_factors(px, segments.gather_decomp(d_t, t_seg), ch))])
    got = segments.find_shifts_segments(px, mask, f8_t, d_t, t_seg, s, EncodeConfig(**kw))
    d = _jax_fit(px, mask, seg, s, ch)
    f8 = j_quantize(*j_extract(_jnp(px), jseg.gather_decomp(d, _jnp(seg)), ch))
    want = jseg.find_shifts_segments(_jnp(px), _jnp(mask), f8, d, _jnp(seg), s, JConfig(**kw))
    flipped = np.zeros(s, bool)
    for f in ENDPOINT_FIELDS:
        flipped |= (getattr(d_t, f).numpy() != np.asarray(getattr(d, f))).any(axis=0)
    differs = (got[0].numpy() != np.asarray(want[0])).any(axis=0)
    differs |= got[1].numpy() != np.asarray(want[1])
    print(f"{kind} {lane} {mode}: {int(flipped.sum())} flipped segments, "
          f"{int(differs.sum())} with other shifts or errors, of {s}")
    assert not (differs & ~flipped).any()


def test_contiguous_forms_equal_jax():
    """``contiguous=True`` is fit_regions / find_shifts with the doubling
    scan, per member (tests/test_torch_segments.py holds it in depth)."""
    px, mask, grid = _blocks("aligned", "rgb")
    nb = grid.num_blocks
    seg = seg_map(np.random.default_rng(4), nb, 9)
    d = _jax_fit(px, mask, seg, nb, 3, contiguous=True)
    got = segments.fit_segments(px, mask, torch.from_numpy(seg), nb, 3, contiguous=True)
    assert all(f.shape == (3, nb) for f in got)
    for f in ENDPOINT_FIELDS:
        assert np.abs(getattr(got, f).numpy() - np.asarray(getattr(d, f))).max() <= 1
    cfg = dict(error_factor=100)
    f8 = j_quantize(*j_extract(_jnp(px), d, 3))
    want = jseg.find_shifts_segments(_jnp(px), _jnp(mask), f8, d, _jnp(seg), nb,
                                     JConfig(**cfg), contiguous=True)
    f8_t = torch.stack([torch.from_numpy(np.asarray(f).astype(np.int32)) for f in f8])
    got = segments.find_shifts_segments(px, mask, f8_t, _to_torch_decomp(d),
                                        torch.from_numpy(seg), nb, EncodeConfig(**cfg),
                                        contiguous=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode,num_factors", [("ladder", 3), ("exhaustive", 2), ("guess", 1)])
def test_block_search_entries_equal_jax(mode, num_factors):
    """find_shifts_exhaustive / _guess / _ladder on int32 inputs, each block
    its own region, as limg_tpu/ops/crush.py:345-370."""
    from limg_tpu.ops.fit import fit_blocks as j_fit_blocks

    px, mask, _ = _blocks("ragged", "rgb")
    cfg = dict(error_factor=100, crush_mode=mode, num_factors=num_factors)
    d = j_drop(j_fit_blocks(_jnp(px), _jnp(mask), 3), num_factors)
    f8 = j_quantize(*j_extract(_jnp(px), d, 3))
    jp, jm = _jnp(px).astype(jnp.int32), _jnp(mask).astype(jnp.int32)
    jf8 = jnp.stack([f.astype(jnp.int32) for f in f8])
    entry = f"find_shifts_{mode}"
    want = getattr(jcrush, entry)(jp, jm, jf8, d, jm.sum(axis=0), JConfig(**cfg))
    tp, tm = px.to(torch.int32), mask.to(torch.int32)
    got = getattr(crush, entry)(tp, tm, torch.from_numpy(np.array(jf8)), _to_torch_decomp(d),
                                tm.sum(dim=0, dtype=torch.int32), EncodeConfig(**cfg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the dispatching find_shifts is the same search
    disp = crush.find_shifts(px, mask, torch.from_numpy(np.array(jf8)), _to_torch_decomp(d),
                             EncodeConfig(**cfg))
    for g, w in zip(disp, got):
        assert torch.equal(g, w)
