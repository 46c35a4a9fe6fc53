"""``owner_crush``: the fused path's crush, dither and decode of every block
at its owner level. The user's call fetches no planes, so no crushed
factors are written."""

from .common import BLOCK_AREA, I32, call_bound, encode_ops, fit_ops


def bound_s(kernel: str, job, emit_q: bool = False) -> float:
    pixels, nb, ch = job.pixels, job.blocks(0), job.cfg.channels
    ops = encode_ops(pixels, pixels, job.cfg) - pixels * fit_ops(ch)
    # words, owner, factors and endpoints in; shifts, decoded words, two
    # errors and bpp out (and the crushed factors with emit_q)
    nbytes = (pixels * I32 + nb * I32 * (1 + BLOCK_AREA + 6 * ch)
              + nb * I32 * (3 + BLOCK_AREA * (2 if emit_q else 1) + 3))
    return call_bound(ops, nbytes)[0]
