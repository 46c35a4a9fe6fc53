"""SHA-256 digests of the port's 4K encodes on the card, to show that two
checkouts encode alike to the last digit.

    python3 tools/encode_digests.py [--root CHECKOUT] [--out FILE.json]

Imports ``limg_tpu_torch`` and ``chip_smoke`` from ``--root`` (default: this
checkout) and runs, on the 4K RGB and RGBA images of chip_smoke.py (dithering
on, seed 0): the fixed-grid ``encode_image``; ``encode_image_merged`` with
its defaults, with ``coalesce=False``, with ``merge_policy="rd"``, with
``fused_layout="natural"``, and on the dense path at 3 and 5 levels; and the
composed coalesce pass (``coalesce_segments(use_kernel=False)``) on the 4K
default state. Each result's digest covers every array and number it
returns. Prints one JSON object {case: digest} (also written to ``--out``);
two checkouts encode alike when their objects are equal. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(obj, h=None):
    """SHA-256 over every array, tensor and number in ``obj`` (nested dicts
    in key order, lists, tuples)."""
    import torch

    top = h is None
    h = hashlib.sha256() if top else h
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            h.update(str(k).encode())
            digest(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            digest(v, h)
    elif isinstance(obj, torch.Tensor):
        digest(obj.detach().cpu().numpy(), h)
    elif isinstance(obj, np.ndarray):
        h.update(f"{obj.dtype}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    else:
        h.update(repr(obj).encode())
    return h.hexdigest() if top else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from tools.record_torch_reference import case_images

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    out = {}
    for lane, img in case_images(2160, 3840).items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=True)
        out[f"{lane} encode_image"] = digest(limg_tpu_torch.encode_image(img, cfg, seed=0,
                                                                         device=device))
        merged = {"default": {}, "coalesce=False": {"coalesce": False},
                  "rd": {"merge_policy": "rd"}, "natural": {"fused_layout": "natural"},
                  "dense 3 levels": {"fused": False},
                  "dense 5 levels": {"fused": False, "num_levels": 5}}
        for name, kw in merged.items():
            res = limg_tpu_torch.encode_image_merged(img, cfg, seed=0, return_state=True,
                                                     device=device, **kw)
            out[f"{lane} encode_image_merged {name}"] = digest(res)
        state = limg_tpu_torch.fused_merged_pre(img, cfg, 0, chip_smoke.MERGED_LEVELS,
                                                device=device)
        out[f"{lane} composed coalesce pass"] = digest(chip_smoke.composed_pass(state, cfg, 0,
                                                                                False))
    text = json.dumps(out, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
