"""Seconds from the process's start to the first timed image: the torch
import and CUDA context, the port's kernels loaded (built, in a checkout's
first run), the pool made and every pool image encoded once."""


def read(run):
    return run.setup_s
