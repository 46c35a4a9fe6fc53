"""Device time of the copies from host memory to a card (the trace's glue rows
of a ``Memcpy HtoD`` operation), ms per call, summed over the cards."""

HTOD = "Memcpy HtoD"


def h2d_s(trace) -> float:
    """Seconds of host-to-device copies in the traced window, every card."""
    return sum(s for key, s in trace.glue_s.items() if HTOD in key)


def read(run):
    if run.trace is None or not run.trace.images or not run.trace.launches:
        return None
    return h2d_s(run.trace) / run.trace.images * 1e3
