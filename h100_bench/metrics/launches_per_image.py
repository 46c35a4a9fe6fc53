"""Device operations (kernels, copies, fills) in the traced window, per image."""


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.launches / run.trace.images
