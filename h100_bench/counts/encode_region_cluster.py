"""``encode_region_cluster``: the region encode of every level above P = 4096,
one kernel for all of them (counts in ``encode_region.py``)."""

from .encode_region import bound_s  # noqa: F401
