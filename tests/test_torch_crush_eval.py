"""limg_tpu_torch's segment crush evaluation and the composed coalesce pass
vs the JAX package (CPU).

``crush_eval_rows_kernel`` (kernels/crush_eval.py) is the counterpart of
``crush_eval_rows_pallas`` / ``crush_eval_rows_k_pallas``
(limg_tpu/pallas_kernels/encode_fixed.py:1021, :1063). On the CPU it runs
its plain version, which must equal JAX's ``ops.crush.evaluate_shifts``
exactly (integer arithmetic) and the recorded interpret-mode output of
``crush_eval_rows_k_pallas`` (tests/fixtures/torch_port_natural_reference.npz,
tools/record_torch_natural_reference.py). ``coalesce_segments(use_kernel=
False)``, the re-encode composed of ops that evaluates its candidates there,
must equal ``use_kernel=True`` bit for bit.

A stride-0 table of triples goes to the kernel as an evaluation plan
(``eval_plan``), worked out on the host: each distinct triple once, in
groups that change one axis; the plan is checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.ops import crush as jcrush
from limg_tpu.ops.fit import Decomposition as JDecomp

import limg_tpu_torch
from limg_tpu_torch import regions
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.kernels import coalesce as kc
from limg_tpu_torch.kernels import crush_eval as kce
from limg_tpu_torch.kernels import launch
from limg_tpu_torch.ops import crush as tcrush
from limg_tpu_torch.ops.dither import coalesce_key
from limg_tpu_torch.ops.fit import Decomposition
from limg_tpu_torch.ops.reduce import SegmentReducer
from tools import record_torch_natural_reference as nrec

torch.set_num_threads(1)


def _inputs(channels, n, k, seed=11):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in nrec.crush_eval_inputs(channels, n=n, k=k, seed=seed)]


@pytest.mark.parametrize("k", [1, 8, 27])
@pytest.mark.parametrize("channels", [3, 4])
def test_crush_eval_matches_jax_evaluate_shifts(channels, k):
    """Every candidate's pixel max and error sum equal JAX's, on a ragged N."""
    packed, mask, f8p, eps, cands = _inputs(channels, 77, k, seed=k)
    pm, be = kce.crush_eval_rows_kernel(packed, mask, f8p, eps, cands, channels)
    assert pm.shape == be.shape == (k, 77) and pm.dtype == be.dtype == torch.int32
    px = np.stack([(packed.numpy() >> (8 * c)) & 0xFF for c in range(channels)])
    f8 = np.stack([(f8p.numpy() >> (8 * a)) & 0xFF for a in range(3)])
    d = JDecomp(jnp.zeros((channels, 77), jnp.float32), *[jnp.asarray(e) for e in eps.numpy()])
    for i in range(k):
        pm_j, be_j = jcrush.evaluate_shifts(jnp.asarray(px), jnp.asarray(mask.numpy()),
                                            jnp.asarray(f8), d, jnp.asarray(cands[i].numpy()),
                                            channels)
        np.testing.assert_array_equal(pm[i].numpy(), np.asarray(pm_j))
        np.testing.assert_array_equal(be[i].numpy(), np.asarray(be_j))


@pytest.mark.parametrize("name", list(nrec.CRUSH_EVAL_CASES))
def test_crush_eval_matches_recorded_pallas_kernel(name):
    """crush_eval_rows_k_pallas in interpret mode, recorded: equal."""
    fx = np.load(nrec.OUT)
    ch = nrec.CRUSH_EVAL_CASES[name]
    pm, be = kce.crush_eval_rows_kernel(*_inputs(ch, nrec.CRUSH_EVAL_N, nrec.CRUSH_EVAL_K), ch)
    np.testing.assert_array_equal(pm.numpy(), fx[f"{name}.pm"])
    np.testing.assert_array_equal(be.numpy(), fx[f"{name}.be"])
    assert int(pm.max()) > 0


_SWEEP = tuple(tuple(s if ax == a else 0 for ax in range(3)) for a in range(3) for s in range(9))
_EVERY = tuple((a, b, c) for a in range(9) for b in range(9) for c in range(9))
_TABLES = {
    "sweep": _SWEEP,
    **{f"exhaustive chunk {i}": _EVERY[81 * i:81 * (i + 1)] for i in range(9)},
    "guess": tcrush.GUESS_TRIPLES,
    "duplicates": tuple(tuple(int(v) for v in t) for t in
                        np.random.default_rng(8).integers(0, 12, (6, 3))[
                            np.random.default_rng(9).integers(0, 6, 23)]),
}


@pytest.mark.parametrize("name", list(_TABLES))
def test_eval_plan_takes_each_distinct_triple_once(name):
    """Every row's triple (a shift above 8 read as 8) is evaluated once, the
    rows map to their triples, and a step that does not rebase keeps the
    previous step's inner axis and the other two shifts, with the inner
    shift ascending."""
    rows = _TABLES[name]
    steps, outs = kce.eval_plan(rows)
    canon = [tuple(min(s, 8) for s in t) for t in rows]
    triples = [t for t, _, _ in steps]
    assert sorted(triples) == sorted(set(canon))
    assert [triples[i] for i in outs] == canon
    assert steps[0][2]
    for (prev, a_prev, _), (t, a, rebase) in zip(steps, steps[1:]):
        if not rebase:
            assert a == a_prev and t[a] > prev[a]
            assert [t[k] for k in range(3) if k != a] == [prev[k] for k in range(3) if k != a]
    words = kce.pack_plan(steps, outs)
    assert words[:2] == [len(steps), len(rows)] and words[2 + len(steps):] == list(outs)
    for w, (t, a, rebase) in zip(words[2:], steps):
        assert (w & 15, (w >> 4) & 15, (w >> 8) & 15, (w >> 12) & 3, w >> 14) == (*t, a, rebase)


def test_eval_plan_groups_as_claimed():
    """The 27 axis sweeps: 25 triples in three groups, (0, 0, 0) once; an
    exhaustive chunk: axis 0 fixed, nine groups of 9 along axis 2 (axis 1
    redecoded nine times, axis 2 at every step); the guess triples: four."""
    rebases = lambda steps: [t for t, _, r in steps if r]
    steps, outs = kce.eval_plan(_SWEEP)
    assert len(steps) == 25 and len(rebases(steps)) == 3
    assert outs[0] == outs[9] == outs[18]
    for i in range(9):
        steps, _ = kce.eval_plan(_EVERY[81 * i:81 * (i + 1)])
        assert {a for _, a, _ in steps} == {2} and {t[0] for t, _, _ in steps} == {i}
        assert [t[1] for t in rebases(steps)] == list(range(9))
    assert len(rebases(kce.eval_plan(tcrush.GUESS_TRIPLES)[0])) == 4
    with pytest.raises(ValueError):
        kce.eval_plan(((0, -1, 0),))


@pytest.mark.parametrize("name", ["sweep", "exhaustive chunk 4", "guess", "duplicates"])
def test_eval_plan_reproduces_the_table(name):
    """The plan's distinct triples, evaluated by the plain version and taken
    by ``outs``, give the whole table's values; the wrapper gives the same
    values on a stride-0 expand as on its contiguous copy."""
    rows = _TABLES[name]
    packed, mask, f8p, eps, _ = _inputs(4, 50, 1, seed=len(rows))
    steps, outs = kce.eval_plan(rows)
    table = tcrush._const_cands(rows, 50, "cpu")
    assert kce.table_of(table) is not None and kce.table_of(table.contiguous()) is None
    want = kce.crush_eval_rows_kernel(packed, mask, f8p, eps, table, 4)
    got = kce.crush_eval_rows_reference(
        packed, mask, f8p, eps, tcrush._const_cands([t for t, _, _ in steps], 50, "cpu"), 4)
    idx = torch.tensor(outs)
    assert torch.equal(got[0][idx], want[0]) and torch.equal(got[1][idx], want[1])
    for a, b in zip(kce.crush_eval_rows_kernel(packed, mask, f8p, eps, table.contiguous(), 4),
                    want):
        assert torch.equal(a, b)


def test_crush_eval_checks_its_inputs():
    packed, mask, f8p, eps, cands = _inputs(3, 40, 2)
    with pytest.raises(ValueError):
        kce.crush_eval_rows_kernel(packed[:32], mask[:32], f8p[:32], eps, cands, 3)
    with pytest.raises(ValueError):
        kce.crush_eval_rows_kernel(packed, mask.bool(), f8p, eps, cands, 3)
    with pytest.raises(ValueError):
        kce.crush_eval_rows_kernel(packed, mask, f8p, eps, cands[:, :2], 3)
    with pytest.raises(RuntimeError, match="no kernel"):
        kce.crush_eval_rows_kernel(*(t.to("meta") for t in (packed, mask, f8p, eps, cands)), 3)


def test_find_shifts_kernel_route_equals_plain_route():
    """find_shifts(use_kernel=True) with a segment reducer: the same shifts;
    it refuses what the kernel does not take (a pre-scaled error)."""
    rng = np.random.default_rng(4)
    packed, mask, f8p, eps, _ = _inputs(3, 120, 1, seed=4)
    seg = torch.from_numpy(np.repeat(np.arange(0, 120, 6), 6).astype(np.int32))
    px = torch.stack([(packed >> (8 * c)) & 0xFF for c in range(3)])
    f8 = torch.stack([(f8p >> (8 * a)) & 0xFF for a in range(3)])
    d = Decomposition(torch.zeros(3, 120), *eps.unbind(0))
    for mode in ("ladder", "exhaustive", "guess"):
        cfg = EncodeConfig(error_factor=int(rng.integers(100, 2000)), crush_mode=mode)
        red = SegmentReducer(seg)
        plain = tcrush.find_shifts(px, mask, f8, d, cfg, red)
        routed = tcrush.find_shifts(px, mask, f8, d, cfg, red, use_kernel=True)
        for a, b in zip(plain, routed):
            assert torch.equal(a, b), mode
    big = torch.zeros((3, 4096, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        tcrush.find_shifts(big, torch.ones((4096, 2), dtype=torch.bool), big,
                           Decomposition(torch.zeros(3, 2), *torch.zeros(6, 3, 2, dtype=torch.int32)),
                           EncodeConfig(), use_kernel=True)


# ---------------------------------------------------------------------------
# coalesce_segments(use_kernel=False): the composed re-encode
# ---------------------------------------------------------------------------

def _state(policy, cfg):
    img = nrec.make_4k_lane(64, 96, "rgba" if cfg.has_alpha else "rgb")
    if policy == "rd":
        return limg_tpu_torch.fused_rd_pre(img, cfg, seed=3, num_levels=3, device="cpu")
    return limg_tpu_torch.fused_merged_pre(img, cfg, seed=3, num_levels=3, device="cpu")


@pytest.mark.parametrize("mode", ["ladder", "exhaustive", "guess"])
@pytest.mark.parametrize("policy", ["match", "rd"])
def test_composed_coalesce_equals_segment_kernel_route(policy, mode):
    cfg = EncodeConfig(error_factor=100, has_alpha=mode == "guess", crush_mode=mode,
                       dithering=mode != "exhaustive", num_factors=2 if mode == "guess" else 3)
    state = _state(policy, cfg)
    outs = []
    for use_kernel in (True, False):
        lv = {k: None if v is None else v.clone() for k, v in state["lv0"].items()}
        res = regions.coalesce_segments(
            state["px"], state["mask"], state["seg0"], state["is_run0"], lv, cfg,
            coalesce_key(3, cfg.dither_seed), state["grid"].num_blocks, need_planes=True,
            merge_policy=policy, rd_lambda=0.01, use_kernel=use_kernel)
        outs.append((lv, res))
    (lv_k, (app_k, runs_k, st_k)), (lv_c, (app_c, runs_c, st_c)) = outs
    assert int(runs_k) > 0 and int(runs_k) == int(runs_c)
    assert torch.equal(app_k, app_c)
    assert {k: int(v) for k, v in st_k.items()} == {k: int(v) for k, v in st_c.items()}
    for key, v in lv_k.items():
        assert torch.equal(v, lv_c[key]), key


def test_composed_segment_encode_is_the_plain_version_on_the_cpu():
    """On CPU tensors the composition takes every kernel's plain version:
    equal to segment_encode_reference, and no kernel launched."""
    from chip_smoke import seeded_run_buffer

    buf = seeded_run_buffer(np.random.default_rng(9), 300, 3, torch.device("cpu"))
    cfg = EncodeConfig(error_factor=100, dithering=True)
    before = launch.launches.copy()
    got = kc.segment_encode_composed(*buf, cfg, 0x5EED)
    want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
    assert launch.launches == before
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
