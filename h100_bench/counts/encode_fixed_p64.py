"""``encode_fixed_p64``: the region encode at P = 64, every 8x8 block."""

from .common import region_encode_bound


def bound_s(kernel: str, job) -> float:
    return region_encode_bound(job, 0)[0]
