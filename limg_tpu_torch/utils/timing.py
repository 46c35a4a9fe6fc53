"""Device timing for the port: CUDA events on a card, the host clock on the CPU.

On a CUDA device each batch of ``inner`` calls is bracketed by two CUDA
events on the current stream, and the elapsed time is read after the end
event completes. On the CPU the host clock is used; such numbers say how
fast the CPU ran the plain versions and are reported with clock "host".
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _batch_seconds(fn, args, inner: int, device: torch.device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(inner):
        fn(*args)
    return time.perf_counter() - t0


def _warm(fn, args, device: torch.device) -> None:
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_device_fn(fn, *args, device, iters: int = 20, inner: int = 5):
    """Returns (median seconds per call, details dict) after one warm-up."""
    device = torch.device(device)
    _warm(fn, args, device)
    samples = np.asarray([_batch_seconds(fn, args, inner, device) / inner
                          for _ in range(max(1, iters // inner))])
    return float(np.median(samples)), {
        "clock": "cuda_event" if device.type == "cuda" else "host",
        "best_s": float(samples.min()),
        "worst_s": float(samples.max()),
        "std_s": float(samples.std(ddof=1)) if samples.size > 1 else 0.0,
        "samples_s": samples.tolist(),
    }


def time_device_fns(fns: dict, device, rounds: int = 10, inner: int = 5) -> dict:
    """Interleaved timing of several paths: each round times a batch of every
    fn in turn, so all see the same card state. Returns
    ``{name: [seconds per call, one per round]}``."""
    device = torch.device(device)
    for fn in fns.values():
        _warm(fn, (), device)
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            samples[name].append(_batch_seconds(fn, (), inner, device) / inner)
    return samples
