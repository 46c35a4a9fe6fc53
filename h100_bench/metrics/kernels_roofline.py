"""The port's kernels that the frozen counts cover, together: the sum of
their bounds (``counts/``) over the sum of their device time, in %. On a
cell of several cards both sums run over every card."""


def read(run):
    if run.trace is None:
        return None
    bound = time = 0.0
    for label, seconds in run.trace.port_s.items():
        b = run.kernel_bound_s(label)
        if b is not None and seconds > 0:
            bound, time = bound + b, time + seconds
    return 100.0 * bound / time if time else None
