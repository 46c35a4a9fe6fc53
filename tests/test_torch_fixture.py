"""limg_tpu_torch on the CPU vs the recorded JAX encode stats.

tests/fixtures/torch_port_reference.json holds the JAX jnp path's stats
(tools/record_torch_reference.py) at 4K, which chip_smoke.py checks on the
card, and at a 256x384 cut of the same image, which these tests check on
the CPU. Tolerances: with dithering off, PSNR 0.02 dB, mean bpp 0.01 and
bits-histogram L1 0.5% of pixels (float sums may flip an endpoint); with it
on, the port's hash dither differs from JAX's threefry, so PSNR 0.3 dB and
bpp 0.1.
"""

import json
import os

import numpy as np
import pytest
import torch

import limg_tpu_torch
from limg_tpu_torch import EncodeConfig
from tools.record_torch_reference import SIZES, case_images

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_port_reference.json")


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def test_fixture_covers_the_smoke_cases(fixture):
    assert fixture["error_factor"] == 100 and fixture["crush_mode"] == "ladder"
    for size, (h, w) in SIZES.items():
        for lane in ("rgb", "rgba"):
            for dith in ("nodither", "dither"):
                case = fixture["cases"][f"{size}_{lane}_{dith}"]
                assert (case["height"], case["width"]) == (h, w)
                hist = np.asarray(case["bits_histogram"])
                assert hist.shape == (3, 9) and (hist.sum(axis=1) == h * w).all()


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("lane", ["rgb", "rgba"])
def test_port_matches_fixture_small(fixture, lane, dithering):
    name = f"small_{lane}_{'dither' if dithering else 'nodither'}"
    ref = fixture["cases"][name]
    img = case_images(*SIZES["small"])[lane]
    cfg = EncodeConfig(error_factor=fixture["error_factor"], has_alpha=lane == "rgba",
                       crush_mode=fixture["crush_mode"], dithering=dithering)
    out = limg_tpu_torch.encode_image(img, cfg, seed=fixture["seed"], device="cpu")
    hist_l1 = int(np.abs(out["bits_histogram"] - np.asarray(ref["bits_histogram"])).sum())
    print(f"{name}: psnr {out['psnr']:.5f} vs {ref['psnr']:.5f}, "
          f"bpp {out['mean_bpp']:.5f} vs {ref['mean_bpp']:.5f}, hist L1 {hist_l1}")
    if dithering:
        assert abs(out["psnr"] - ref["psnr"]) <= 0.3
        assert abs(out["mean_bpp"] - ref["mean_bpp"]) <= 0.1
    else:
        assert abs(out["psnr"] - ref["psnr"]) <= 0.02
        assert abs(out["mean_bpp"] - ref["mean_bpp"]) <= 0.01
        assert hist_l1 <= 0.005 * img.shape[0] * img.shape[1]
