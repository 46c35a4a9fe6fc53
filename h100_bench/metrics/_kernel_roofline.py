"""One kernel's bound (``counts/``) over its device time in the trace, in %."""


def share(run, label: str):
    if run.trace is None or run.trace.port_s.get(label, 0.0) <= 0:
        return None
    bound = run.kernel_bound_s(label)
    return None if bound is None else 100.0 * bound / run.trace.port_s[label]
