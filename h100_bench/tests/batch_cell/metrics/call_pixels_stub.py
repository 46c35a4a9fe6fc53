"""The pixels of one call of the window, the mean over its calls."""


def read(run):
    return run.pixels / run.images if run.images else None
