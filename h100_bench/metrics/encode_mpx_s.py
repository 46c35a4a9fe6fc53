"""Pixels encoded over the whole window, in Mpx/s: every call's pixels (an
image's, or a batch's frames together) over the window's time, from its
start to the end of its last call."""


def read(run):
    if not run.images or run.window_s <= 0:
        return None
    return run.pixels / run.window_s / 1e6
