"""limg_tpu_torch.bitstream against limg_tpu.bitstream (CPU).

The serializer is host code on the same arrays in both packages, so from
the same state the two write the same bytes, on the native factor path and
on the NumPy one (``LIMG_TPU_DISABLE_NATIVE_FACTOR``), with entropy coding
on and off. The states: JAX's, from tests/fixtures/torch_port_natural_
reference.npz (whose streams tests/fixtures/torch_port_ltp1_reference.json
records, tools/record_torch_ltp1_reference.py), and the port's own CPU
encodes of the same cases and of the RD policy. A stream decodes to the
encode's decoded image bit for bit, in both packages.
"""

import json

import numpy as np
import pytest
import torch

from limg_tpu import bitstream as jb
from limg_tpu.config import EncodeConfig as JConfig

import limg_tpu_torch
from limg_tpu_torch import bitstream as tb
from limg_tpu_torch.config import EncodeConfig
from tests.conftest import make_test_image
from tools import record_torch_dense_reference as drec
from tools import record_torch_ltp1_reference as lrec
from tools import record_torch_merged_reference as mrec
from tools import record_torch_natural_reference as nrec

torch.set_num_threads(1)

ENTROPY = list(lrec.ENTROPY.items())
H, W = 48, 72
CFG = EncodeConfig(error_factor=100)


@pytest.fixture(params=["native", "numpy"])
def factor_path(request, monkeypatch):
    """Both packages' factor sections on the native path, or on NumPy."""
    if request.param == "numpy":
        monkeypatch.setenv("LIMG_TPU_DISABLE_NATIVE_FACTOR", "1")
    else:
        monkeypatch.delenv("LIMG_TPU_DISABLE_NATIVE_FACTOR", raising=False)
    return request.param


@pytest.fixture(scope="module")
def fixture():
    return np.load(nrec.OUT)


@pytest.fixture(scope="module")
def dense_fixture():
    fx = np.load(drec.OUT)
    return fx, json.loads(str(fx["meta"]))


@pytest.fixture(scope="module")
def port_encodes():
    """case -> the port's CPU encode of it, (out, state), made once."""
    encodes = {}

    def get(name):
        if name not in encodes:
            make, levels, over, coalesce, _ = nrec.CASES[name]
            cfg = EncodeConfig(**mrec.config_kwargs(over))
            encodes[name] = limg_tpu_torch.encode_image_merged(
                make(), cfg, num_levels=levels, coalesce=coalesce, return_state=True,
                device="cpu")
        return encodes[name]

    return get


def _configs(name):
    kw = mrec.config_kwargs(nrec.CASES[name][2])
    return EncodeConfig(**kw), JConfig(**kw)


def _packed_q(state):
    """The state with ``q`` as (64, NB) packed int32 words, the JAX dense
    path's form."""
    q = state["q"].astype(np.int32)
    return {**state, "q": q[0] | (q[1] << 8) | (q[2] << 16)}


@pytest.mark.parametrize("key,entropy", ENTROPY)
@pytest.mark.parametrize("name", lrec.STATE_CASES)
def test_fixture_states_give_jax_bytes(fixture, port_encodes, factor_path, name, key, entropy):
    """JAX's state and the port's own encode of the case give the bytes
    JAX writes and recorded; so do the state as torch tensors and with the
    dense path's packed factor words."""
    cfg, jcfg = _configs(name)
    state = lrec.state_of(fixture, name)
    blob = tb.serialize_from_state(state, cfg, entropy=entropy)
    assert blob == jb.serialize_from_state(state, jcfg, entropy=entropy)
    assert lrec.digest(blob) == lrec.reference_streams()[name][key]
    _, port_state = port_encodes(name)
    assert tb.serialize_from_state(port_state, cfg, entropy=entropy) == blob
    as_tensors = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in port_state.items()}
    assert tb.serialize_from_state(as_tensors, cfg, entropy=entropy) == blob
    packed = _packed_q(state)
    assert tb.serialize_from_state(packed, cfg, entropy=entropy) == blob
    assert jb.serialize_from_state(packed, jcfg, entropy=entropy) == blob


@pytest.mark.parametrize("name", lrec.STATE_CASES)
def test_deserialize_equals_jax_and_the_encode(fixture, port_encodes, factor_path, name):
    cfg, jcfg = _configs(name)
    out, state = port_encodes(name)
    for entropy in (True, False):
        blob = tb.serialize_from_state(state, cfg, entropy=entropy)
        dec, info = tb.deserialize(blob)
        jdec, jinfo = jb.deserialize(blob)
        np.testing.assert_array_equal(dec, jdec)
        assert info == jinfo
        np.testing.assert_array_equal(dec, out["decoded"])
        assert dec.shape == (*out["decoded"].shape[:2], 4) and dec.dtype == np.uint8
        if cfg.channels == 3:
            assert (dec[..., 3] == 255).all()
        assert info["n_runs"] == out["n_runs"] == state["n_runs"]


@pytest.mark.parametrize("has_alpha", [False, True])
def test_rd_state_gives_jax_bytes(factor_path, has_alpha):
    """The RD policy (its fixture holds no state): the port's state, entropy
    on and off; ``serialize(merge_policy="rd")`` is the encode that charges
    the real header cost."""
    img = make_test_image(np.random.default_rng(12), 64, 96)
    if not has_alpha:
        img = img[..., :3].copy()
    cfg = EncodeConfig(error_factor=100, has_alpha=has_alpha)
    jcfg = JConfig(error_factor=100, has_alpha=has_alpha)
    out, state = limg_tpu_torch.encode_image_merged(
        img, cfg, merge_policy="rd", return_state=True,
        rd_header_bits=tb.region_header_bits(cfg.channels), device="cpu")
    for entropy in (True, False):
        blob = tb.serialize_from_state(state, cfg, entropy=entropy)
        assert blob == jb.serialize_from_state(state, jcfg, entropy=entropy)
        dec, info = tb.deserialize(blob)
        np.testing.assert_array_equal(dec, out["decoded"])
        assert info["n_runs"] == out["n_runs"]
    assert tb.serialize(img, cfg, merge_policy="rd", device="cpu") == \
        tb.serialize_from_state(state, cfg)


def test_serialize_equals_serialize_from_state_and_round_trips():
    img = make_test_image(np.random.default_rng(3), H, W)
    out, state = limg_tpu_torch.encode_image_merged(img, CFG, return_state=True, device="cpu")
    blob = tb.serialize(img, CFG, device="cpu")
    assert blob == tb.serialize_from_state(state, CFG)
    dec, info = tb.deserialize(blob)
    np.testing.assert_array_equal(dec, out["decoded"])
    assert info["levels"] == 3 and info["real_bpp"] < 32
    raw = tb.serialize(img, CFG, entropy=False, device="cpu")
    np.testing.assert_array_equal(tb.deserialize(raw)[0], dec)
    assert len(blob) <= len(raw) + 3


@pytest.mark.parametrize("num_levels", [1, 5])
def test_serialize_outside_2_to_4_levels_names_item_13(num_levels, dense_fixture):
    """num_levels=1 (the dense path, ROADMAP.md Queue 1 item 13, landed)
    and num_levels=5 (Queue 1 item 16, landed) write JAX's bytes: the
    port's state of the recorded encode is JAX's
    (tests/fixtures/torch_port_dense_reference.npz,
    torch_port_levels_reference.npz), and so are its streams, entropy on and
    off; ``serialize`` is that encode's stream. The 1-level stream decodes
    to the encode; the 5-level one is refused by ``deserialize`` with JAX's
    ValueError, as the JAX package's own reader refuses it (ROADMAP.md
    Queue 3)."""
    if num_levels == 5:
        from tools import record_torch_levels_reference as lrec

        fx = np.load(lrec.OUT)
        meta = json.loads(str(fx["meta"]))
        name = "band70x90_rgb_l5"
        img = lrec.SMALL_CASES[name][0]()
    else:
        fx, meta = dense_fixture
        name = "band70x90_rgb_l1"
        img = drec.SMALL_CASES[name][0]()
    cfg = EncodeConfig(**meta["cases"][name]["config"])
    jcfg = JConfig(**meta["cases"][name]["config"])
    out, state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=num_levels,
                                                    return_state=True, device="cpu")
    np.testing.assert_array_equal(state["rows"], fx[f"{name}.state_rows"])
    np.testing.assert_array_equal(state["q"], fx[f"{name}.state_q"])
    jstate = dict(state, rows=fx[f"{name}.state_rows"], q=fx[f"{name}.state_q"])
    for entropy in (True, False):
        blob = tb.serialize_from_state(state, cfg, entropy=entropy)
        assert blob == jb.serialize_from_state(jstate, jcfg, entropy=entropy)
    assert drec.stream_digest(blob) == str(fx[f"{name}.stream_raw_sha256"])
    blob = tb.serialize(img, cfg, num_levels=num_levels, device="cpu")
    assert blob == tb.serialize_from_state(state, cfg)
    assert drec.stream_digest(blob) == str(fx[f"{name}.stream_sha256"])
    if num_levels == 5:
        for reader in (tb.deserialize, jb.deserialize):
            with pytest.raises(ValueError, match="corrupt LTP1 stream: bad dimensions/levels"):
                reader(blob)
        return
    dec, info = tb.deserialize(blob)
    np.testing.assert_array_equal(dec, out["decoded"])
    assert info["levels"] == 1 and info["n_runs"] == out["n_runs"] > 0


def test_helpers_equal_jax(rng):
    for ch in (3, 4):
        assert tb.region_header_bits(ch) == jb.region_header_bits(ch)
    for width in range(0, 9):
        vals = rng.integers(0, 1 << width, 1000).astype(np.uint8)
        packed = tb._pack_bits(vals, width)
        np.testing.assert_array_equal(packed, jb._pack_bits(vals, width))
        assert len(packed) == (-(-1000 * width // 8))
        np.testing.assert_array_equal(tb._unpack_bits(packed, 1000, width), vals)
    owner = rng.integers(0, 3, 9 * 13)
    lead = tb._lead_levels(owner, 9, 13, 3)
    np.testing.assert_array_equal(lead, jb._lead_levels(owner, 9, 13, 3))
    for got, want in zip(tb._segments_of(owner, lead, owner.size),
                         jb._segments_of(owner, lead, owner.size)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb._block_mask(37, 53), jb._block_mask(37, 53))


def test_reject_garbage():
    with pytest.raises(ValueError):
        tb.deserialize(b"NOPE" + b"\x00" * 100)
    with pytest.raises(ValueError):
        tb.deserialize(b"LT")


def test_truncated_streams_raise():
    """Corrupt or truncated blobs raise, never silently decode garbage."""
    img = make_test_image(np.random.default_rng(5), H, W)
    blob = tb.serialize(img, CFG, device="cpu")
    for cut in (9, len(blob) // 3, len(blob) - 3):
        with pytest.raises(Exception):
            tb.deserialize(blob[:cut])
    with pytest.raises(ValueError, match="trailing bytes"):
        tb.deserialize(blob + b"\x00")


def test_flat_image_single_region():
    """A flat image collapses to ~one region: the quadtree merges to the
    top level and the coalesce pass runs the remaining squares into one
    rectangle (tests/test_bitstream.py:164)."""
    img = np.full((H, W, 4), 90, np.uint8)
    img[..., 3] = 255
    out, state = limg_tpu_torch.encode_image_merged(img, CFG, return_state=True, device="cpu")
    blob = tb.serialize_from_state(state, CFG)
    assert blob == jb.serialize_from_state(state, JConfig(error_factor=100))
    dec, info = tb.deserialize(blob)
    assert info["n_segments"] <= 3 and info["n_runs"] >= 1
    np.testing.assert_array_equal(dec, out["decoded"])
    assert len(blob) < 54 * 16
