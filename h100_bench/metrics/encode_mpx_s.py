"""Pixels encoded over the whole window, in Mpx/s: every image's pixels over
the window's time, from its start to the end of its last image."""


def read(run):
    if not run.images or run.window_s <= 0:
        return None
    return run.images * run.pixels_per_image / run.window_s / 1e6
