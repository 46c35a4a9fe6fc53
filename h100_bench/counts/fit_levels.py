"""``fit_levels``: the fused path's fit of every level, merge test and owner
select, in one pass over the (H, W) words."""

from .common import BLOCK_AREA, I32, call_bound, fit_ops


def bound_s(kernel: str, job) -> float:
    pixels, nb, ch, lv = job.pixels, job.blocks(0), job.cfg.channels, job.num_levels
    ops = lv * pixels * fit_ops(ch)
    # words in; per block the count, the factors, endpoints, means, owner,
    # stats and a reason row per merged level out
    nbytes = pixels * I32 + nb * I32 * (1 + BLOCK_AREA + 6 * ch + ch + 1 + 1 + (lv - 1))
    return call_bound(ops, nbytes)[0]
