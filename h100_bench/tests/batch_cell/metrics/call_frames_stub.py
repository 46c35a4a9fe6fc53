"""The frames of the first traced call's count job."""


def read(run):
    if run.trace is None or not run.trace.traced_indices:
        return None
    return run.bound_jobs(run.trace.traced_indices[0]).frames
