"""Device time of the port's own kernels (``__global__`` functions of its
``csrc/``), ms per image: per call in a batched cell, summed over the
cards of a cell of several."""


def read(run):
    if run.trace is None or not run.trace.images or not run.trace.port_s:
        return None
    return sum(run.trace.port_s.values()) / run.trace.images * 1e3
