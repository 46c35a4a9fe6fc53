"""limg_tpu_torch crush search vs the JAX package, fed JAX's own factors (CPU).

The search is integer arithmetic (plus float32 floors in the reduced-factor
modes), so given the same f8 planes and decomposition the chosen shifts
must be bit-exact, for every crush mode, num_factors and channel count
that tests/test_pallas_kernel.py covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.ops import crush as jcrush
from limg_tpu.ops import layout as jlayout
from limg_tpu.ops.factors import extract_factors, quantize_factors
from limg_tpu.ops.fit import drop_decomposition_axes, fit_blocks

from limg_tpu_torch.config import config_from_jax
from limg_tpu_torch.ops import crush as tcrush
from limg_tpu_torch.ops.fit import Decomposition
from tests.conftest import make_test_image

torch.set_num_threads(1)

_find_shifts = jax.jit(jcrush.find_shifts, static_argnames="cfg")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_factors():
    """Per channel count: JAX's blocks, mask, decomposition and f8 planes."""
    img = make_test_image(np.random.default_rng(77), 40, 56)
    px, mask, _ = jlayout.blockify(jnp.asarray(img))
    out = {}
    for ch in (3, 4):
        d = fit_blocks(px, mask, ch)
        out[ch] = (px, mask, d, quantize_factors(*extract_factors(px, d, ch)))
    return out


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("num_factors", [1, 2, 3])
@pytest.mark.parametrize("mode", ["ladder", "exhaustive", "guess", "none"])
def test_find_shifts_matches_jax(jax_factors, channels, num_factors, mode):
    px, mask, d, f8 = jax_factors[channels]
    jcfg = JConfig(error_factor=100, has_alpha=channels == 4, crush_mode=mode,
                   dithering=False, num_factors=num_factors)
    d = drop_decomposition_axes(d, num_factors)
    want, _ = _find_shifts(px, mask, f8, d, jcfg)
    got, _ = tcrush.find_shifts(_t(px), _t(mask), [_t(p) for p in f8],
                                Decomposition(*[_t(v) for v in d]), config_from_jax(jcfg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode != "none":
        assert int(got.sum()) > 0   # the case exercises real crushing


@pytest.mark.parametrize("channels", [3, 4])
def test_evaluate_shifts_matches_jax(jax_factors, channels):
    px, mask, d, f8 = jax_factors[channels]
    nb = px.shape[-1]
    pxi = px[:channels].astype(jnp.int32)
    mask_i = mask.astype(jnp.int32)
    f8i = jnp.stack([p.astype(jnp.int32) for p in f8])
    td = Decomposition(*[_t(v) for v in d])
    rng = np.random.default_rng(5)
    for _ in range(3):
        shifts = rng.integers(0, 9, size=(3, nb)).astype(np.int32)
        pm_j, be_j = jcrush.evaluate_shifts(pxi, mask_i, f8i, d, jnp.asarray(shifts), channels)
        pm_t, be_t = tcrush.evaluate_shifts(_t(pxi), _t(mask_i), _t(f8i), td,
                                            torch.from_numpy(shifts), channels)
        np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
        np.testing.assert_array_equal(be_t.numpy(), np.asarray(be_j))
