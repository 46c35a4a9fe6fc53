"""Device timing for the port: CUDA events on a card, the host clock on the CPU.

On a CUDA device each batch of ``inner`` calls is bracketed by two CUDA
events on the current stream, and the elapsed time is read after the end
event completes. On the CPU the host clock is used; such numbers say how
fast the CPU ran the plain versions and are reported with clock "host".

``device_busy_ms`` (the JAX package's, limg_tpu/utils/timing.py:108, reads
an xplane trace) sums the device time of every kernel a call launches,
from ``torch.profiler``'s CUDA events (``profile_device``); on the CPU
there is no device trace and it returns None.
"""

from __future__ import annotations

import time
from typing import NamedTuple

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


class DeviceProfile(NamedTuple):
    """Device time per call, in us, by kernel (``kernels``) and by the
    PyTorch operation that launched a kernel itself (``ops``; the port's
    own kernels are launched by no operation), and the host wall per call
    of the profiled window, which ends in a synchronize."""

    kernels: dict
    ops: dict
    wall_us: float

    @property
    def busy_us(self) -> float:
        return sum(self.kernels.values())


def profile_device(fn, iters: int = 3, *, device, windows: int = 2) -> DeviceProfile | None:
    """``torch.profiler`` over ``iters`` calls of ``fn`` on a CUDA ``device``,
    after a warm call; the last of ``windows`` windows is kept (the first
    pays the profiler's start-up). None on a device with no trace (the
    CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    by_type = {DeviceType.CUDA: {}, DeviceType.CPU: {}}
    for e in prof.key_averages():
        if e.device_type in by_type and e.self_device_time_total > 0:
            by_type[e.device_type][e.key] = e.self_device_time_total / iters
    return DeviceProfile(by_type[DeviceType.CUDA], by_type[DeviceType.CPU], wall_us)


def device_busy_ms(fn, iters: int = 3, *, device) -> float | None:
    """Device-busy ms per call of ``fn``: the device time of every kernel it
    launches, summed (``profile_device``). None where no device trace
    exists: on the CPU, or when the profiler saw no kernel."""
    prof = profile_device(fn, iters, device=device)
    if prof is None or not prof.kernels:
        return None
    return prof.busy_us / 1e3
