"""limg_tpu_torch.utils.diagnostics against limg_tpu.utils.diagnostics (CPU).

The culprit counts are integer decodes and errors of the same inputs, so
both packages give the same dicts exactly: ``crush_culprits_merged`` on the
serializer states of tests/fixtures/torch_port_natural_reference.npz (JAX's)
and on the port's own encodes, and ``crush_culprits`` on a JAX fixed-grid
fit carried to torch, at 8x8 blocks and at 64x64-pixel regions, whose
block error is pre-scaled (``err_scale_shift``, regions of 2048 pixels or
more).

The encode paths' spans and counters (``span``, ``count``,
``record_counts``): off without a listener; under ``torch.profiler`` on the
CPU each path's stage spans land in the Chrome trace inside its entry
span, and the segment counters count each coalesce buffer; the corpus
encodes' spans nest in theirs, and their counters count each shard's frames
and the bytes it sent from host memory to a card.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops import layout as jlayout
from limg_tpu.ops.crush import find_shifts as jfind_shifts
from limg_tpu.ops.factors import extract_factors as jextract, quantize_factors as jquantize
from limg_tpu.ops.fit import fit_blocks as jfit_blocks
from limg_tpu.utils import diagnostics as jd

import limg_tpu_torch
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.ops.crush import err_scale_shift
from limg_tpu_torch.ops.fit import Decomposition
from limg_tpu_torch.parallel import mesh
from limg_tpu_torch.utils import diagnostics as td
from tests.conftest import make_test_image
from tools import record_torch_ltp1_reference as lrec
from tools import record_torch_merged_reference as mrec
from tools import record_torch_natural_reference as nrec

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture():
    return np.load(nrec.OUT)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", lrec.STATE_CASES)
def test_merged_culprits_equal_jax_on_fixture_states(fixture, name):
    make, levels, over, coalesce, _ = nrec.CASES[name]
    kw = mrec.config_kwargs(over)
    cfg, jcfg = EncodeConfig(**kw), JConfig(**kw)
    img = make()
    state = lrec.state_of(fixture, name)
    want = jd.crush_culprits_merged(img, state, jcfg)
    assert td.crush_culprits_merged(img, state, cfg, device="cpu") == want
    # the image as a tensor: its device is the one used
    assert td.crush_culprits_merged(torch.from_numpy(img), state, cfg) == want
    _, port_state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels,
                                                       coalesce=coalesce, return_state=True,
                                                       device="cpu")
    assert td.crush_culprits_merged(img, port_state, cfg, device="cpu") == \
        jd.crush_culprits_merged(img, port_state, jcfg)


@pytest.mark.parametrize("levels,policy,has_alpha", [(4, "match", False), (4, "rd", True),
                                                     (3, "rd", False)])
def test_merged_culprits_equal_jax_on_port_states(levels, policy, has_alpha):
    """Port encodes whose regions reach 64x64 pixels (4 levels) and the RD
    policy's state, with dithering on."""
    img = make_test_image(np.random.default_rng(40), 128, 200)
    img[:128, :128, :3] = (90, 140, 60)       # four flat 64x64 squares
    if not has_alpha:
        img = img[..., :3].copy()
    cfg, jcfg = EncodeConfig(has_alpha=has_alpha), JConfig(has_alpha=has_alpha)
    out, state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels,
                                                    merge_policy=policy, return_state=True,
                                                    device="cpu")
    if levels == 4:
        assert (state["rows"][0] == 3).any()
    got = td.crush_culprits_merged(img, state, cfg, device="cpu")
    assert got == jd.crush_culprits_merged(img, state, jcfg)
    assert got["blocks"] > 0 and sum(got[k] for k in ("pixel_bound", "block_bound",
                                                       "saturated", "expandable")) > 0


@pytest.mark.parametrize("block,mode,has_alpha,seeded", [
    (8, "ladder", False, False), (8, "exhaustive", True, False), (8, "guess", False, False),
    (64, "ladder", False, False), (64, "ladder", True, False), (64, "ladder", False, True),
    (64, "ladder", True, True)])
def test_fixed_grid_culprits_equal_jax(block, mode, has_alpha, seeded):
    """JAX's fit, factors and shifts carried to torch: the same dict. At
    64x64-pixel regions the block error is pre-scaled by 16; seeded shift
    triples in place of the search's reach the regions where that moves a
    count (RGBA here: one region expandable with the pre-scale, pixel
    bound without)."""
    h, w = (40, 72) if block == 8 else (128, 192)
    img = make_test_image(np.random.default_rng(block + has_alpha), h, w)
    jcfg = JConfig(has_alpha=has_alpha, crush_mode=mode)
    cfg = EncodeConfig(has_alpha=has_alpha, crush_mode=mode)
    px, mask, _ = jlayout.blockify(jnp.asarray(img), block)
    d = jfit_blocks(px, mask, cfg.channels)
    f8 = jquantize(*jextract(px, d, cfg.channels))
    shifts, _ = jfind_shifts(px, mask, f8, d, jcfg)
    if seeded:
        shifts = jnp.asarray(np.random.default_rng(5).integers(0, 9, shifts.shape), jnp.int32)
    want = jd.crush_culprits(px, mask, f8, d, shifts, jcfg)
    td_d = Decomposition(*(_t(v) for v in d))
    got = td.crush_culprits(_t(px), _t(mask), [_t(f) for f in f8], td_d, _t(shifts), cfg)
    assert got == want
    assert err_scale_shift(block * block) == (4 if block == 64 else 0)
    assert got["blocks"] == px.shape[-1]


@pytest.mark.parametrize("with_stats", [False, True])
def test_format_culprits_equals_jax(with_stats):
    crush = {"blocks": 1234, "pixel_bound": 17, "block_bound": 900, "saturated": 3,
             "expandable": 314}
    merge = [{"fast_accept": 3.0, "avg_diff_reject": 12.0}, {"ratio_reject": 0.5}]
    coalesce = {"dropped_runs_at_capacity": 0, "rejected_runs": 41}
    args = (crush, merge, coalesce) if with_stats else (crush,)
    assert td.format_culprits(*args) == jd.format_culprits(*args)
    assert td.format_culprits({**crush, "blocks": 0}) == jd.format_culprits({**crush, "blocks": 0})


def _spans_and_counts(tmp_path, path: str):
    """One small encode of ``path`` under ``profile_trace``: its program
    spans [(name, start, end)] and its counters."""
    cfg = EncodeConfig()
    img = make_test_image(np.random.default_rng(7), 72, 136)
    with td.profile_trace(str(tmp_path / path)) as log_dir:
        if path == "corpus":
            mesh.encode_corpus_sharded(_corpus_frames(), cfg, n_devices=4, seed=3, device="cpu")
        elif path == "fixed":
            limg_tpu_torch.encode_image_device(img, cfg, 3, device="cpu")
        else:
            limg_tpu_torch.encode_image_merged(img, cfg, 3, num_levels=5 if path == "dense" else 3,
                                               fetch_planes=False, device="cpu")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(log_dir, "counters.json")) as f:
        counts = json.load(f)
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e["name"].startswith("limg.")]
    return spans, counts


PATH_SPANS = {
    "fused": ("limg.encode_image_merged", ["limg.pre.fit", "limg.pre.crush", "limg.pre.leaders",
                                           "limg.pre.runs", "limg.run_count_read",
                                           "limg.finish.coalesce", "limg.finish.totals",
                                           "limg.fetch"]),
    "dense": ("limg.encode_image_merged",
              [f"limg.dense.{s}.L{lvl}" for s in ("encode", "coalesce") for lvl in range(5)]
              + ["limg.dense.merge", "limg.dense.runs", "limg.dense.totals",
                 "limg.dense.decoded", "limg.fetch"]),
    "fixed": ("limg.encode_image_device", ["limg.fixed.blockify", "limg.fixed.encode",
                                           "limg.fixed.assemble"]),
    # four shards on four devices: each stage once a shard, then the call's
    "corpus": ("limg.encode_corpus_sharded",
               [f"limg.corpus.{s}" for s in ("upload", "blockify", "encode", "stats")] * 4
               + ["limg.corpus.gather", "limg.fetch"]),
}
CORPUS_SHAPE = (8, 24, 40, 3)


def _corpus_frames() -> np.ndarray:
    """A (8, 24, 40, 3) uint8 batch in host memory."""
    return np.random.default_rng(11).integers(0, 256, CORPUS_SHAPE, dtype=np.uint8)


@pytest.mark.parametrize("path", sorted(PATH_SPANS))
def test_encode_spans_nest_in_their_entry_span(tmp_path, path):
    """Every stage span of the path once (the dense ones once a level),
    inside the one entry span, and no other program span."""
    entry, stages = PATH_SPANS[path]
    spans, counts = _spans_and_counts(tmp_path, path)
    assert sorted(name for name, _, _ in spans) == sorted([entry] + stages)
    (t0, t1), = [(s, e) for name, s, e in spans if name == entry]
    assert all(t0 <= s and e <= t1 for _, s, e in spans)
    if path == "corpus":
        # a shard's frames; on a mesh of cpu devices no byte crosses to a card
        n = CORPUS_SHAPE[0]
        assert counts == {"limg.corpus.frames": [n // 4] * 4,
                          "limg.corpus.upload_bytes": [0] * 4}
        return
    # a coalesce buffer a pass: P = 64 on the fused path, one a level on the dense
    ps = {"fused": [64], "dense": [64 << 2 * lvl for lvl in range(5)], "fixed": []}[path]
    assert sorted(counts) == sorted(f"limg.segments.{k}.p{p}" for k in ("members", "lanes")
                                    for p in ps)
    for p in ps:
        (members,), (lanes,) = counts[f"limg.segments.members.p{p}"], \
            counts[f"limg.segments.lanes.p{p}"]
        assert 0 <= members <= lanes


def test_corpus_counts_no_upload_for_a_batch_on_its_device():
    """A tensor already on the mesh's device brings no bytes from host
    memory; its frames are counted all the same."""
    with td.record_counts() as rec:
        mesh.encode_corpus_sharded(torch.from_numpy(_corpus_frames()), EncodeConfig(),
                                   n_devices=4, seed=3, device="cpu")
    assert rec.drain() == {"limg.corpus.frames": [2] * 4, "limg.corpus.upload_bytes": [0] * 4}


def test_corpus_counts_the_bytes_a_shard_sends_from_host_memory():
    """A shard of a batch in host memory bound for a device that is not the
    CPU (``meta`` here, which holds no data) counts all its bytes; the same
    shard kept on the CPU counts none."""
    n, h, w, c = CORPUS_SHAPE
    batch = torch.from_numpy(_corpus_frames())
    with td.record_counts() as rec:
        shards = [mesh._upload(batch, k, n // 4, torch.device("meta")) for k in range(4)]
        mesh._upload(batch, 0, n // 4, torch.device("cpu"))
    assert [s.shape for s in shards] == [(n // 4, h, w, c)] * 4
    assert rec.drain() == {"limg.corpus.frames": [n // 4] * 5,
                           "limg.corpus.upload_bytes": [n // 4 * h * w * c] * 4 + [0]}


@pytest.mark.parametrize("entry", ["merged", "mixed"])
def test_corpus_entries_span_their_bodies_and_uploads(tmp_path, entry):
    """The merged and mixed corpus encodes: the entry's span around every
    program span, one upload a shard, and the shard counters."""
    frames = _corpus_frames()[:4]
    with td.profile_trace(str(tmp_path / entry)) as log_dir:
        if entry == "merged":
            mesh.encode_corpus_sharded_merged(frames, EncodeConfig(), n_devices=2, seed=3,
                                              device="cpu")
        else:
            mesh.encode_corpus_sharded_mixed(list(frames), EncodeConfig(), n_devices=2,
                                             seed=3, device="cpu")
    with open(os.path.join(log_dir, "trace.json")) as f:
        spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e["name"].startswith("limg.")]
    (t0, t1), = [(s, e) for name, s, e in spans
                 if name == f"limg.encode_corpus_sharded_{entry}"]
    assert all(t0 <= s and e <= t1 for _, s, e in spans)
    names = [name for name, _, _ in spans]
    assert names.count("limg.corpus.upload") == 2
    assert names.count("limg.corpus.gather") == 1
    with open(os.path.join(log_dir, "counters.json")) as f:
        counts = json.load(f)
    assert counts["limg.corpus.frames"] == [2, 2]
    assert counts["limg.corpus.upload_bytes"] == [0, 0]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with td.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64).sum()
        td.count("limg.test", 3)
        td.count("limg.test", torch.tensor(4))
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(os.path.join(log_dir, "counters.json")) as f:
        assert json.load(f) == {"limg.test": [3, 4]}


def test_spans_and_counts_are_off_without_a_listener(monkeypatch):
    """No profiler, no recording: ``span`` never enters ``record_function``
    (here made to raise) and is one shared object; ``count`` keeps nothing,
    through a whole encode as well."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert td.span("limg.a") is td.span("limg.b")
    td.count("limg.a", torch.ones(()))
    img = make_test_image(np.random.default_rng(8), 40, 72)
    limg_tpu_torch.encode_image_merged(img, EncodeConfig(), fetch_planes=False, device="cpu")
    with td.record_counts() as rec:
        pass
    assert rec.values == {} and rec.drain() == {}
    assert td._RECORDINGS.get() == ()


def test_record_counts_keeps_each_open_recording():
    """Nested recordings both keep a count made inside both; device values
    stay tensors until ``drain``, which gives ints in call order."""
    td.count("limg.x", 1)
    with td.record_counts() as outer:
        td.count("limg.x", torch.tensor(2, dtype=torch.int64))
        with td.record_counts() as inner:
            td.count("limg.x", torch.tensor(True).sum())
            td.count("limg.y", 5)
        td.count("limg.y", 6)
    assert isinstance(outer.values["limg.x"][0], torch.Tensor)
    assert outer.drain() == {"limg.x": [2, 1], "limg.y": [5, 6]}
    assert inner.drain() == {"limg.x": [1], "limg.y": [5]}
