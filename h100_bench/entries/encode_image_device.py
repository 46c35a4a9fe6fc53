"""``encode_image_device``: the fixed 8x8 grid encode, as its users call it.

The window calls ``lib.encode_image_device(image, cfg, seed)``, which
leaves the decoded image and the block results on the device, and reads
back the totals a user reads: the factor bits per axis and the bits
histogram. The check compares the decoded image, the shifts, crushed
factors and endpoints of every block, and the histogram with the
reference's.
"""

from __future__ import annotations

import torch

from ..harness.entry import Output


def call(lib, image, cfg, seed: int, params: dict, device) -> Output:
    decoded, res, _ = lib.encode_image_device(image, cfg, seed, device=device, **params)
    totals = dict(accum_bits=res.accum_bits.cpu().numpy(),
                  bits_histogram=res.bits_histogram.cpu().numpy())
    return Output(totals, (decoded, res.shifts, res.factors, tuple(res.decomposition[1:])))


def compare(got: Output, want: Output, image) -> dict:
    """- ``px_gap``: the share of pixels decoded differently (decode, dither);
    - ``blk_gap``: the share of blocks whose shifts, crushed factors or
      endpoints differ (fit, crush);
    - ``hist_gap``: the bits histogram's L1 gap over its total."""
    (dec_g, sh_g, f_g, eps_g), (dec_w, sh_w, f_w, eps_w) = got.kept, want.kept
    if dec_g.shape != dec_w.shape or sh_g.shape != sh_w.shape:
        return dict(px_gap=float("inf"), blk_gap=float("inf"), hist_gap=float("inf"))
    px = (dec_g != dec_w.to(dec_g.device)).any(dim=-1)
    blk = (sh_g != sh_w.to(sh_g.device)).any(dim=0)
    blk |= (f_g != f_w.to(f_g.device)).any(dim=1).any(dim=0)
    for a, b in zip(eps_g, eps_w):
        blk |= (a != b.to(a.device)).any(dim=0)
    hist_g = torch.as_tensor(got.totals["bits_histogram"])
    hist_w = torch.as_tensor(want.totals["bits_histogram"])
    return dict(px_gap=float(px.float().mean()), blk_gap=float(blk.float().mean()),
                hist_gap=float((hist_g - hist_w).abs().sum()) / max(int(hist_w.sum()), 1))


def run_members(lib, image, cfg, seed: int, params: dict, device) -> dict:
    """No run buffer on the fixed grid."""
    return {}
