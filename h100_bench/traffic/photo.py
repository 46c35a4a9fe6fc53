"""Photo-like images made on the device from a seed.

The recipe of ``tools/make_test_image.make_4k`` (smooth colour waves, a
Gaussian blob, Gaussian noise, a flat patch), evaluated in float32 with
torch wherever the images are served, from parameters in a traffic file
(``traffic/<name>.json``):

    height, width        the frame
    pool                 distinct images made at set-up
    base                 the three channels' constant levels
    waves                [channel, amplitude, "sin" | "cos", x period, y period]:
                         amplitude * fn(x / x period + y / y period); a period
                         of 0 leaves its axis out
    blobs                {"center": [y, x], "sigma": s, "amplitude": [r, g, b]}:
                         amplitude * exp(-|p - center|^2 / (2 s^2))
    noise_sigma          standard deviation of the per-pixel noise
    patches              {"rows": [y0, y1], "cols": [x0, x1], "rgb": [r, g, b]}

The noise of image i comes from a ``torch.Generator`` on the device seeded
from (seed, i), so a seed gives the same pool on the same device every
time. The result is clipped to [0, 255] and truncated to uint8, as NumPy's
``astype`` does.
"""

from __future__ import annotations

import torch

_MASK63 = (1 << 63) - 1


def image_seed(seed: int, index: int) -> int:
    """The generator seed of pool image ``index`` under the run's ``seed``
    (any integer; the result fits the generator's 63 bits)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & _MASK63


def deterministic(params: dict, device) -> torch.Tensor:
    """(H, W, 3) float32: the recipe before the noise and the patches."""
    h, w = int(params["height"]), int(params["width"])
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    chans = [torch.full((h, w), float(b), dtype=torch.float32, device=device)
             for b in params["base"]]
    fns = {"sin": torch.sin, "cos": torch.cos}
    for c, amp, fn, xp, yp in params.get("waves", []):
        arg = torch.zeros((h, w), dtype=torch.float32, device=device)
        if xp:
            arg = x / xp
        if yp:
            arg = arg + y / yp if xp else y / yp
        chans[c] = chans[c] + amp * fns[fn](arg)
    for blob in params.get("blobs", []):
        cy, cx = blob["center"]
        g = torch.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * float(blob["sigma"]) ** 2))
        for c, amp in enumerate(blob["amplitude"]):
            if amp:
                chans[c] = chans[c] + amp * g
    return torch.stack(chans, dim=-1)


def make_pool(params: dict, seed: int, device) -> list[torch.Tensor]:
    """``params["pool"]`` distinct (H, W, 3) uint8 images on ``device``."""
    base = deterministic(params, device)
    sigma = float(params.get("noise_sigma", 0.0))
    pool = []
    for i in range(int(params["pool"])):
        img = base
        if sigma:
            gen = torch.Generator(device=device)
            gen.manual_seed(image_seed(seed, i))
            img = base + sigma * torch.randn(base.shape, generator=gen, dtype=torch.float32,
                                             device=device)
        for patch in params.get("patches", []):
            (y0, y1), (x0, x1) = patch["rows"], patch["cols"]
            img[y0:y1, x0:x1] = torch.tensor(patch["rgb"], dtype=torch.float32, device=device)
        pool.append(img.clamp_(0, 255).to(torch.uint8))
        del img
    return pool
