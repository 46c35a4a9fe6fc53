"""``encode_region_p<P>`` (P = 256, 1024, 4096) and ``encode_region_cluster``
(every P above 4096, one kernel for all of them): the region encode of the
dense path's levels."""

from .common import BLOCK_AREA, region_encode_bound


def _level(pixels: int) -> int:
    return ((pixels // BLOCK_AREA).bit_length() - 1) // 2


def bound_s(kernel: str, job) -> float | None:
    if kernel == "encode_region_cluster":
        levels = range(_level(16384), job.num_levels)
    elif kernel.startswith("encode_region_p"):
        levels = [_level(int(kernel[len("encode_region_p"):]))]
    else:
        return None
    if not levels:
        return None
    return sum(region_encode_bound(job, lvl)[0] for lvl in levels)
