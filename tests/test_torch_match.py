"""limg_tpu_torch.ops.match vs the JAX package's match_decomps (CPU).

The same decomposition pairs, made with numpy from a seed or fitted from a
test image, go through both predicates. The port adds the 27 probe
deviations in one fixed order (a left fold, then / 27); XLA may use
another, so a match or reason bit may differ only where the probe mean lies
within 1e-5 of the 3.0 threshold. Those pairs are counted and must be few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limg_tpu.ops.fit import Decomposition as JDecomp
from limg_tpu.ops.fit import fit_blocks as j_fit
from limg_tpu.ops.match import match_decomps as j_match
from limg_tpu.pallas_kernels.encode_merged import MATCH_REASON_BITS as J_REASON_BITS

from limg_tpu_torch.ops import layout
from limg_tpu_torch.ops.fit import Decomposition, fit_blocks
from limg_tpu_torch.ops.match import (MATCH_REASON_BITS, _MAX_FACTOR_SUM, match_decomps,
                                      probe_deviation_mean, reason_bits)
from tests.conftest import make_test_image

torch.set_num_threads(1)
NEAR = 1e-5


def _random_decomps(rng, n, ch, base=None, jitter=None):
    """Decompositions with endpoints in the fit's ranges; with ``base``, a
    small perturbation of it (pairs that reach the ratio and probe tests)."""
    if base is None:
        avg = rng.uniform(0, 255, (ch, n)).astype(np.float32)
        a_min = rng.integers(0, 200, (ch, n))
        fields = [a_min, a_min + rng.integers(0, 56, (ch, n))]
        for _ in range(2):
            off = rng.integers(-40, 10, (ch, n))
            fields += [off, off + rng.integers(0, 50, (ch, n))]
        return (avg, *(f.astype(np.int32) for f in fields))
    avg = (base[0] + rng.normal(0, jitter, base[0].shape)).astype(np.float32)
    return (avg, *(f + rng.integers(-2, 3, f.shape).astype(np.int32) for f in base[1:]))


def _fitted_pairs(ch):
    """Fitted decompositions of neighbouring blocks (right and down)."""
    img = make_test_image(np.random.default_rng(91), 96, 128)[..., :ch]
    px, mask, g = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)))
    d = fit_blocks(px, mask, ch)
    f = [t.numpy().reshape(ch, g.blocks_y, g.blocks_x) for t in d]
    right = [(x[..., :, 1:].reshape(ch, -1), x[..., :, :-1].reshape(ch, -1)) for x in f]
    down = [(x[..., 1:, :].reshape(ch, -1), x[..., :-1, :].reshape(ch, -1)) for x in f]
    a = [np.concatenate([r[0], dn[0]], axis=1) for r, dn in zip(right, down)]
    b = [np.concatenate([r[1], dn[1]], axis=1) for r, dn in zip(right, down)]
    return tuple(a), tuple(b)


def _compare(a, b, ch):
    m_j, st_j = j_match(JDecomp(*map(jnp.asarray, a)), JDecomp(*map(jnp.asarray, b)), ch)
    ta = Decomposition(*map(torch.from_numpy, a))
    tb = Decomposition(*map(torch.from_numpy, b))
    m_t, st_t = match_decomps(ta, tb, ch)
    dev_mean = probe_deviation_mean(ta, tb, ch)[0].numpy()
    near = np.abs(dev_mean - _MAX_FACTOR_SUM) < NEAR
    bits_j = sum(np.asarray(st_j[name]).astype(np.int32) * bit for name, bit in J_REASON_BITS)
    bits_t = reason_bits(st_t).numpy()
    diff = (np.asarray(m_j) != m_t.numpy()) | (bits_j != bits_t)
    assert not (diff & ~near).any(), np.nonzero(diff & ~near)
    return int(diff.sum()), int(near.sum()), int(m_t.sum())


def test_reason_bits_match_the_kernel_table():
    assert MATCH_REASON_BITS == J_REASON_BITS


@pytest.mark.parametrize("channels", [3, 4])
def test_match_on_random_pairs(channels):
    rng = np.random.default_rng(2024 + channels)
    n = 4096
    a = _random_decomps(rng, n, channels)
    b = _random_decomps(rng, n, channels)
    near_b = _random_decomps(rng, n, channels, base=a, jitter=6.0)
    flips, near, matches = _compare(a, b, channels)
    flips2, near2, matches2 = _compare(a, near_b, channels)
    print(f"ch={channels}: random {matches} matches, perturbed {matches2}; "
          f"{flips + flips2} bit flips, {near + near2} means within {NEAR} of 3.0")
    assert matches2 > n // 10          # the perturbed pairs reach the probe test
    assert flips + flips2 <= max(2, (near + near2))
    assert near + near2 <= 2 * n // 1000


@pytest.mark.parametrize("channels", [3, 4])
def test_match_on_fitted_neighbours(channels):
    a, b = _fitted_pairs(channels)
    flips, near, matches = _compare(a, b, channels)
    n = a[0].shape[1]
    print(f"ch={channels}: {n} fitted pairs, {matches} match, {flips} flips, {near} near 3.0")
    assert 0 < matches < n
    assert near <= max(2, n // 1000)


@pytest.mark.parametrize("channels", [3, 4])
def test_match_keeps_argument_roles(channels):
    """a is the candidate, b the reference: the probe sum adds a's terms
    first, so swapping the pair changes the float result on some pairs, and
    both orders agree with JAX's."""
    rng = np.random.default_rng(7)
    a = _random_decomps(rng, 2048, channels)
    b = _random_decomps(rng, 2048, channels, base=a, jitter=10.0)
    ta, tb = (Decomposition(*map(torch.from_numpy, x)) for x in (a, b))
    dev_ab = probe_deviation_mean(ta, tb, channels)[0]
    dev_ba = probe_deviation_mean(tb, ta, channels)[0]
    assert (dev_ab != dev_ba).any()
    _compare(b, a, channels)


def test_match_on_fitted_blocks_of_jax_fit():
    """JAX's own fit feeds both predicates the same endpoints."""
    img = make_test_image(np.random.default_rng(5), 64, 96)[..., :3]
    px, mask, g = layout.blockify(torch.from_numpy(np.ascontiguousarray(img)))
    d = j_fit(jnp.asarray(px.numpy()), jnp.asarray(mask.numpy()), 3)
    f = [np.asarray(x).reshape(3, g.blocks_y, g.blocks_x) for x in d]
    a = tuple(x[..., :, 1:].reshape(3, -1) for x in f)
    b = tuple(x[..., :, :-1].reshape(3, -1) for x in f)
    flips, near, _ = _compare(a, b, 3)
    assert flips <= near
