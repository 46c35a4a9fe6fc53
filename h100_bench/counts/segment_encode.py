"""``segment_encode_p64``: the coalesce pass's re-encode of the run buffer.

A lane whose segment holds no member pixel needs no fit, search or decode,
and its pixels need not be read: count the fit, search and finish of the
member lanes, every lane's mask, ids and outputs (the member rule of
``chip_smoke.py``). The member and lane counts of an image come from its
run building (``job.members["segment_encode"]``); where they are not known
(the dense path's per-level buffers) the counts do not cover the call.
"""

from .common import BLOCK_AREA, I32, call_bound, encode_ops


def lane_bound(members: int, lanes: int, p: int, ch: int, cfg, emit_q: bool = False) -> tuple:
    ops = encode_ops(members * p, members * p, cfg)
    per_lane_in = p * 1 + 2 * I32                               # mask, segment id, block
    per_lane_out = I32 * (3 + p * (2 if emit_q else 1) + 3 + 6 * ch + ch)
    nbytes = members * p * I32 + lanes * (per_lane_in + per_lane_out)
    return call_bound(ops, nbytes)


def bound_s(kernel: str, job, emit_q: bool = False) -> float | None:
    counts = job.members.get("segment_encode")
    if kernel != "segment_encode_p64" or not counts:
        return None
    return lane_bound(counts["members"], counts["lanes"], BLOCK_AREA, job.cfg.channels,
                      job.cfg, emit_q)[0]
