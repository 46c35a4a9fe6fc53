"""Device operations (kernels, copies, fills) in the traced window, per image
(per call in a batched cell), on every card of the cell."""


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.launches / run.trace.images
