"""Record the JAX package's dense merged encode at 5 and 6 quadtree levels as
the port's reference.

The dense path is the one encode of the JAX package that runs 5 levels or
more (its fused path stops at 4, ``MAX_FUSED_LEVELS``): level 4's regions
are 128x128 pixels (P = 16,384), level 5's 256x256 (P = 65,536). This runs
the public ``limg_tpu.regions.encode_image_merged(..., use_pallas=False,
fused=False, fetch_planes=True, return_state=True)`` on the CPU with
dithering off, ladder crush at error_factor 100 unless a case says
otherwise, and writes tests/fixtures/torch_port_levels_reference.npz with
the fields of tools/record_torch_dense_reference.py:

- small cases: ``make_4k(256, 384)`` RGB and RGBA at 5 and 6 levels, match
  and RD (RD charging LTP1's real region header), coalescing on and off,
  ``cap_frac`` 8, the 70x90 image at 5 levels (its one level-4 region
  ragged and partly masked; its state kept), one exhaustive
  ``num_factors=2`` case, and the 256x384 image with a flat top half at 5
  levels (match) and 6 (RD), whose level-4 regions merge and run: the
  stats, ``n_runs``, ``coalesce_stats``, per block the owner level,
  shifts, bpp, region id and endpoint rows, the factor and decoded
  planes' block hashes, the state's and streams' SHA-256;
- 4K RGB and RGBA at 5 levels and 4K RGB at 6 levels: the stats, the owner
  map and run flags, the state's and streams' SHA-256 (held against the
  card only).

    JAX_PLATFORMS=cpu python tools/record_torch_levels_reference.py [--skip-4k] [--jobs N]

Each case runs in a process of its own; ``--jobs`` runs that many at once.
A small case takes one to a few minutes, a 4K case ten or more.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.record_torch_dense_reference import record_case as _record_case  # noqa: E402
from tools.record_torch_dense_reference import run_cases  # noqa: E402
from tools.record_torch_merged_reference import SMALL, fused_band_image, make_4k_lane  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_levels_reference.npz")


def _small(lane: str):
    return lambda: make_4k_lane(*SMALL, lane)


def _flat_top(lane: str):
    """``make_4k(256, 384)`` with its top 128 rows one colour: level 4's
    top three 128x128 regions merge and run, so the region and segment
    encodes at P = 16,384 decide pixels."""
    def make():
        img = make_4k_lane(*SMALL, lane).copy()
        img[:128, :, :3] = (96, 160, 48)
        return img
    return make


_RGBA = {"has_alpha": True}
_EXH = {"crush_mode": "exhaustive", "num_factors": 2}

# name -> (image maker, levels, config overrides, policy, coalesce, cap_frac,
#          RD charges the LTP1 header, keep the state)
SMALL_CASES = {
    "small_rgb_l5": (_small("rgb"), 5, {}, "match", True, 0, False, False),
    "small_rgba_l5": (_small("rgba"), 5, _RGBA, "match", True, 0, False, False),
    "small_rgb_l6": (_small("rgb"), 6, {}, "match", True, 0, False, False),
    "small_rgba_l6": (_small("rgba"), 6, _RGBA, "match", True, 0, False, False),
    "small_rgb_l5_rd_hdr": (_small("rgb"), 5, {}, "rd", True, 0, True, False),
    "small_rgba_l5_rd_hdr": (_small("rgba"), 5, _RGBA, "rd", True, 0, True, False),
    "small_rgb_l6_rd_hdr": (_small("rgb"), 6, {}, "rd", True, 0, True, False),
    "small_rgb_l5_nocoalesce": (_small("rgb"), 5, {}, "match", False, 0, False, False),
    "small_rgba_l6_rd_nocoalesce": (_small("rgba"), 6, _RGBA, "rd", False, 0, False, False),
    "small_rgb_l5_cap8": (_small("rgb"), 5, {}, "match", True, 8, False, False),
    "band70x90_rgb_l5": (fused_band_image, 5, {}, "match", True, 0, False, True),
    "small_rgb_l5_exh_nf2": (_small("rgb"), 5, _EXH, "match", True, 0, False, False),
    "flattop_rgb_l5": (_flat_top("rgb"), 5, {}, "match", True, 0, False, True),
    "flattop_rgba_l6_rd_hdr": (_flat_top("rgba"), 6, _RGBA, "rd", True, 0, True, False),
}
FULL_CASES = {
    "4k_rgb_l5": ("rgb", 5, {}),
    "4k_rgba_l5": ("rgba", 5, _RGBA),
    "4k_rgb_l6": ("rgb", 6, {}),
}


def record_case(name: str):
    """Run one case; returns (arrays keyed "<name>.<field>", its meta)."""
    return _record_case(name, SMALL_CASES, FULL_CASES)


def main(argv=None):
    run_cases(argv, os.path.abspath(__file__), OUT,
              "JAX_PLATFORMS=cpu python tools/record_torch_levels_reference.py",
              SMALL_CASES, FULL_CASES, __doc__)


if __name__ == "__main__":
    main()
