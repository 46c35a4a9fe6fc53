"""``encode_fixed_p64`` (the region encode of every 8x8 block): its bound over
its device time, in %."""

from ._kernel_roofline import share


def read(run):
    return share(run, "encode_fixed_p64")
