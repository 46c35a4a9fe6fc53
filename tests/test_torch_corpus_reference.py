"""limg_tpu_torch.parallel.mesh.encode_corpus_sharded against its plain
reference, h100_bench.reference.corpus (CPU).

The reference is written from the benchmark's frozen plain modules alone, so
on a mesh of four ``cpu`` devices the port's per-frame ``bpp`` and ``psnr``
and its ``mean_psnr`` equal it to the bit, with dithering on and off, RGB and
RGBA, on frames whose edges are padded. The shard seed is part of the
result: with dithering on a shard draws from its first frame's seed, so two
shards and four give other bits, and the port follows the reference in both.
"""

import numpy as np
import pytest
import torch

from h100_bench import reference
from h100_bench.reference import corpus as ref_corpus
from limg_tpu_torch.config import EncodeConfig
from limg_tpu_torch.parallel import mesh

torch.set_num_threads(1)

SEED = 2**31 + 4321


def _frames(n: int, h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Seeded frames: smooth gradients and noise, so the crush search has work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                     ((x + y) * 127 // max(h + w - 2, 1)), np.full_like(x, 200)], axis=-1)
    noise = rng.normal(0, 12, size=(n, h, w, 4))
    return np.clip(base[None] + noise, 0, 255).astype(np.uint8)[..., :channels]


def _configs(dithering: bool, channels: int):
    kw = dict(error_factor=100, has_alpha=channels == 4, dithering=dithering,
              crush_mode="ladder", ladder_k=8, num_factors=3)
    return EncodeConfig(**kw), reference.EncodeConfig(**kw)


def _both(frames, dithering, channels, n_devices, seed=SEED):
    cfg, cfg_r = _configs(dithering, channels)
    got = mesh.encode_corpus_sharded(frames, cfg, n_devices=n_devices, seed=seed, device="cpu")
    want = ref_corpus.encode_corpus_sharded(frames, cfg_r, n_devices, seed, ("cpu",) * n_devices)
    return got, want


def _assert_bit_equal(got, want):
    for k in ("psnr", "bpp"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["mean_psnr"] == want["mean_psnr"]


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("n,h,w", [(8, 72, 120), (4, 50, 77)])
def test_port_equals_the_reference_to_the_bit(dithering, channels, n, h, w):
    frames = _frames(n, h, w, channels, seed=n * 1000 + h + channels)
    got, want = _both(frames, dithering, channels, n_devices=4)
    _assert_bit_equal(got, want)
    assert got["psnr"].shape == (n,) and np.all(got["bpp"] > 0)


def test_the_shard_seed_moves_the_dither_and_the_port_follows():
    frames = _frames(8, 72, 120, 3, seed=77)
    got2, want2 = _both(frames, True, 3, n_devices=2)
    got4, want4 = _both(frames, True, 3, n_devices=4)
    _assert_bit_equal(got2, want2)
    _assert_bit_equal(got4, want4)
    # frames 2 and 6 open a shard on four devices and not on two: their
    # dither, so their decode and error, differ; frames 0 and 4 open one on both
    assert not np.array_equal(want2["psnr"], want4["psnr"])
    assert want2["psnr"][0] == want4["psnr"][0] and want2["psnr"][4] == want4["psnr"][4]


def test_the_reference_takes_arrays_and_tensors_and_refuses_uneven_shards():
    frames = _frames(4, 24, 40, 3, seed=5)
    _, cfg_r = _configs(True, 3)
    cpus = (torch.device("cpu"),) * 2
    _assert_bit_equal(ref_corpus.encode_corpus_sharded(frames, cfg_r, 2, SEED, cpus),
                      ref_corpus.encode_corpus_sharded(torch.from_numpy(frames), cfg_r, 2, SEED,
                                                       cpus))
    with pytest.raises(ValueError):
        ref_corpus.encode_corpus_sharded(frames[:3], cfg_r, 2, SEED, cpus)
    with pytest.raises(ValueError):
        ref_corpus.encode_corpus_sharded(frames, cfg_r, 2, SEED, cpus + cpus[:1])
