"""Device time of every operation that is not one of the port's own kernels
(PyTorch's kernels, copies and fills: the plain-torch glue), ms per image:
per call in a batched cell, summed over the cards of a cell of several."""


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return sum(run.trace.glue_s.values()) / run.trace.images * 1e3
