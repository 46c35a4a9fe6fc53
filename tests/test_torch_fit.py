"""limg_tpu_torch fit and factor extraction vs the JAX package (CPU).

Float sums run in another order in torch (a fixed halving tree) than in
XLA, so a rounded endpoint may move by 1 (as tests/test_jax_vs_golden.py
allows between jnp and golden); the number of blocks with such a flip is
printed and bounded. Given the same endpoints, factor extraction is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.ops import layout as jlayout
from limg_tpu.ops.factors import extract_factors as j_extract, quantize_factors as j_quant
from limg_tpu.ops.fit import fit_blocks as j_fit

from limg_tpu_torch.ops import layout as tlayout
from limg_tpu_torch.ops.factors import extract_factors as t_extract, quantize_factors as t_quant
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS, Decomposition, _sqrt, fit_blocks as t_fit, tree_sum
from tests.conftest import make_test_image

torch.set_num_threads(1)

IMAGES = {"40x56": (40, 56, 77), "64x96": (64, 96, 78)}
_j_fit = jax.jit(j_fit, static_argnames="channels")


def _image(name):
    h, w, seed = IMAGES[name]
    return make_test_image(np.random.default_rng(seed), h, w)


def _to_torch_decomp(d) -> Decomposition:
    return Decomposition(*[torch.from_numpy(np.array(v)) for v in d])


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("channels", [3, 4])
def test_fit_endpoints_match_jax(name, channels):
    img = _image(name)
    jpx, jmask, _ = jlayout.blockify(jnp.asarray(img))
    tpx, tmask, _ = tlayout.blockify(torch.from_numpy(img))
    jd = _j_fit(jpx, jmask, channels)
    td = t_fit(tpx, tmask, channels)
    np.testing.assert_allclose(td.avg.numpy(), np.asarray(jd.avg), rtol=1e-5, atol=1e-4)
    nb = tpx.shape[-1]
    flipped = np.zeros(nb, bool)
    for f in ENDPOINT_FIELDS:
        diff = np.abs(getattr(td, f).numpy() - np.asarray(getattr(jd, f)))
        assert diff.max() <= 1, (f, diff.max())
        flipped |= (diff > 0).any(axis=0)
    print(f"{name} ch={channels}: {flipped.sum()} of {nb} blocks with a +-1 endpoint flip")
    assert flipped.sum() <= 0.01 * nb


@pytest.mark.parametrize("name", list(IMAGES))
@pytest.mark.parametrize("channels", [3, 4])
def test_factors_match_jax_given_same_endpoints(name, channels):
    img = _image(name)
    jpx, jmask, _ = jlayout.blockify(jnp.asarray(img))
    jd = _j_fit(jpx, jmask, channels)
    want = j_quant(*j_extract(jpx, jd, channels))
    got = t_quant(*t_extract(torch.from_numpy(np.array(jpx)), _to_torch_decomp(jd), channels))
    m = np.asarray(jmask)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(np.where(m, g.numpy(), 0), np.where(m, np.asarray(w), 0))


def test_flat_and_ragged_blocks():
    """Flat blocks collapse to avg with zero B/C; masked pixels are ignored."""
    img = np.full((13, 19, 4), 77, np.uint8)
    img[..., 1] = 140
    px, mask, grid = tlayout.blockify(torch.from_numpy(img))
    d = t_fit(px, mask, 4)
    np.testing.assert_array_equal(d.dirA_min.numpy(), np.array([[77], [140], [77], [77]]).repeat(grid.num_blocks, 1))
    assert torch.equal(d.dirA_min, d.dirA_max)
    for f in ENDPOINT_FIELDS[2:]:
        assert int(getattr(d, f).abs().max()) == 0


def test_tree_sum_is_halving_order():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 64, 5)).astype(np.float32))
    want = x
    for _ in range(6):
        n = want.shape[1] // 2
        want = want[:, :n] + want[:, n:]
    assert torch.equal(tree_sum(x, 1), want[:, 0])
    with pytest.raises(ValueError):
        tree_sum(x[:, :48], 1)


def test_sqrt_is_correctly_rounded():
    """The fit's sqrt is the kernels' sqrtf: the float64 root rounded to
    float32 (PyTorch's CPU float32 sqrt is an ulp off on some inputs)."""
    x = np.random.default_rng(5).uniform(1e-3, 800, 71680).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_sqrt(torch.from_numpy(x)).numpy(), want)
