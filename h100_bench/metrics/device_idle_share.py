"""The share of the traced window in which no operation ran on the device,
in %: 1 minus the union of a card's busy intervals over the window, the
cards' mean on a cell of several cards (``harness/trace.py``)."""


def read(run):
    if run.trace is None or not run.trace.launches or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
