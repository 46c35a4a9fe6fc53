"""The photo traffic generator (traffic/photo.py) against make_4k's recipe."""

import json
from pathlib import Path

import numpy as np
import torch

from h100_bench.traffic import photo

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic" / "photo-45mp.json"


def _params(h=120, w=200, pool=2):
    return dict(json.loads(TRAFFIC.read_text()), height=h, width=w, pool=pool)


def _numpy_recipe(h, w):
    """tools/make_test_image.make_4k before its noise and its patch."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        120 + 80 * np.sin(x / 300) + 40 * np.cos(y / 200),
        100 + 70 * np.cos(x / 250 + y / 400),
        140 + 60 * np.sin((x + y) / 350),
    ], axis=-1)
    blob = 80 * np.exp(-((x - 2000) ** 2 + (y - 1000) ** 2) / (2 * 400 ** 2))
    img[..., 0] += blob
    img[..., 2] -= blob
    return img


def test_deterministic_part_is_the_numpy_recipe():
    # a cut that holds the blob's centre and the patch
    got = photo.deterministic(_params(1100, 2100), "cpu").numpy()
    np.testing.assert_allclose(got, _numpy_recipe(1100, 2100), rtol=0, atol=1e-3)


def test_full_image_is_the_recipe_plus_noise_of_its_sigma():
    from tools.make_test_image import make_4k

    p = _params(700, 1600, pool=1)
    img = photo.make_pool(p, 5, "cpu")[0].numpy().astype(np.float64)
    want = make_4k(700, 1600, seed=5).astype(np.float64)
    np.testing.assert_array_equal(img[500:700, 500:1500], want[500:700, 500:1500])
    # away from the clip, image minus recipe is noise of sigma 6
    det = _numpy_recipe(700, 1600)
    inside = (det > 40) & (det < 215)
    inside[500:700, 500:1500] = False
    resid = (img + 0.5 - det)[inside]
    assert abs(resid.std() - 6.0) < 0.1 and abs(resid.mean()) < 0.1


def test_a_seed_gives_the_same_pool_and_pool_images_differ():
    p = _params()
    big = 2**31 + 12345
    a, b = photo.make_pool(p, big, "cpu"), photo.make_pool(p, big, "cpu")
    assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert a[0].dtype == torch.uint8 and a[0].shape == (120, 200, 3)
    assert not torch.equal(photo.make_pool(p, big + 1, "cpu")[0], a[0])
