"""The control of the check: the reference in the program's place, computed
in bfloat16 sums (``reference.precision.lowered``).

It has the public names the entries call, so a run can take it as its
program: ``readings.py --control`` measures what the check reads when the
timed path computes one precision below the configuration's float32. The
benchmark's own runs never use it.
"""

from __future__ import annotations

from . import reference
from .reference import EncodeConfig  # noqa: F401 -- the entries build their config from it


def encode_image_merged(*args, **kwargs):
    with reference.lowered():
        return reference.encode_image_merged(*args, **kwargs)


def encode_image_device(*args, **kwargs):
    with reference.lowered():
        return reference.encode_image_device(*args, **kwargs)
