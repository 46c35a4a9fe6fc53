"""``segment_encode`` at P = 64 (the coalesce pass's re-encode): its bound
over its device time, in %. The member lanes come from the image's run
building."""

from ._kernel_roofline import share


def read(run):
    return share(run, "segment_encode_p64")
