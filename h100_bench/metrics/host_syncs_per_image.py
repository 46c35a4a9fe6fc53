"""Blocking runtime calls (stream, device or event synchronise, synchronous
copies) in the traced window, per image: each is a host read of a device
value. Per call in a batched cell."""


def read(run):
    if run.trace is None or not run.trace.launches:
        return None
    return run.trace.host_syncs / run.trace.images
