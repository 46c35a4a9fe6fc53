"""One run of one cell: set-up, the measured window, the check, the result.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the traffic's pool of items from ``--seed`` (an item is what
one call encodes: an (H, W, C) image, or a (B, H, W, C) batch of frames)
and encodes each once through the cell's entry (the first run in a
checkout builds the port's kernels there). The cell runs on its ``chips``
cards, ``cuda:0`` ... (``cell_devices``): a traffic generator and an
entry get the card of a one-card cell, or the tuple of the cards of a cell
of several (``call_device``). The window is a closed loop with
one call in flight, an image or a batch: call k encodes pool item k %
pool with seed ``--seed + k``, and its latency runs from the call to its
totals on the host. The window ends with the first call that finishes
``--seconds`` or more after it began. With ``--trace 1`` a steady stretch
of the window is profiled (``harness/trace.py``, card by card) and the
line carries the per-layer metrics in place of the end-to-end ones.

After the window (every card's peak memory read, the program's state
freed) a sample of its calls drawn from the seed is encoded again by the
frozen plain reference (``reference/``) with the same item and seed, and
the entry's numbers (``entries/<entry>.compare``) are held to the cell's
limits: ``correct``. The last line of standard output is one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``memory_peak_bytes`` the fullest card's, ``memory_peak_bytes_per_card``
in card order; traced, ``busy_s`` the mean over the cards and
``busy_s_per_card``), (traced) ``breakdown``, and last ``check``: each
number compared with its limit, also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import entry as entries
from . import spec
from . import trace as tracing

# top-level module names that may not be in the process once the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "limg_tpu")
PROGRAM = "limg_tpu_torch"
# set-up encodes use seeds far from the window's
WARM_SEED_OFFSET = 1 << 40


class Refused(RuntimeError):
    """The run cannot measure here: no card, too few cards, no program."""


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="h100_bench/run.py",
                                description="One run of one cell of the benchmark.")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="inputs and the check's sample")
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: profile part of the window, report the per-layer metrics")
    return p.parse_args(argv)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache under the checkout's ``build/``."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(root / "build" / sub)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def import_program(root: Path):
    """The package under test, from this checkout only."""
    import importlib

    try:
        lib = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise Refused(f"cannot import {PROGRAM}: {e}") from e
    path = Path(lib.__file__).resolve()
    if root.resolve() not in path.parents:
        raise Refused(f"{PROGRAM} comes from {path}, not from the checkout {root}")
    return lib


def cell_devices(chips: int) -> tuple:
    """The cell's cards, ``cuda:0`` ... ``cuda:{chips - 1}``, after checking
    that they are there."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: no card to measure")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    return tuple(torch.device("cuda", i) for i in range(chips))


def call_device(devices: tuple):
    """What a traffic generator and an entry take as their ``device``: the
    card of a one-card cell, the tuple of the cards of a cell of several."""
    return tuple(devices) if len(devices) > 1 else devices[0]


def synchronize(devices: tuple) -> None:
    """Wait for the work queued on every card of ``devices``."""
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def item_frames(item) -> tuple:
    """(frames, height, width) of a pool item: an (H, W, C) image is one
    frame, a (B, H, W, C) batch B."""
    *lead, h, w, _ = item.shape
    return (int(lead[0]) if lead else 1), int(h), int(w)


def item_pixels(item) -> int:
    """The pixels one call of ``item`` encodes: frames x H x W."""
    frames, h, w = item_frames(item)
    return frames * h * w


class Reservoir:
    """A uniform sample of ``size`` of the window's outputs, drawn from the
    seed while the window runs (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items = size, random.Random(seed), []

    def offer(self, k: int, out) -> None:
        if len(self.items) < self.size:
            self.items.append((k, out))
            return
        j = self.rng.randrange(k + 1)
        if j < self.size:
            self.items[j] = (k, out)


@dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read. An "image" of
    a reader (``images``, the ``*_per_image`` metrics, a latency) is one
    call: one image, or one batch of frames in a batched cell."""

    setup_s: float
    latencies_s: list
    window_s: float
    pixels: int                          # every pixel the window's calls encoded
    trace: tracing.Trace | None = None
    bound_jobs: object = None            # call index -> counts.common.Job, for the counts
    _bounds: dict = field(default_factory=dict)

    @property
    def images(self) -> int:
        return len(self.latencies_s)

    def kernel_bound_s(self, label: str) -> float | None:
        """The bound of a port kernel's work in the traced calls, summed
        (``counts/``); None where no count covers it."""
        if label not in self._bounds:
            mod = spec.count_module(label)
            total = None
            if mod is not None and self.trace is not None and self.trace.traced_indices:
                per = [mod.bound_s(label, self.bound_jobs(k)) for k in self.trace.traced_indices]
                total = None if any(b is None for b in per) else sum(per)
            self._bounds[label] = total
        return self._bounds[label]


def _window(call, pool: list, seed: int, seconds: float, reservoir: Reservoir, trace_plan,
            devices: tuple):
    """The closed loop. Returns (latencies, window seconds, failures, the
    stopped profiler or None, traced call indices)."""
    import torch

    lat, failures, traced = [], [], []
    prof = done = None
    trace_t0 = 0.0
    t0 = time.perf_counter()
    k = 0
    while True:
        if trace_plan and prof is None and done is None \
                and time.perf_counter() - t0 >= trace_plan["after_s"]:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            trace_t0 = time.perf_counter()
        t = time.perf_counter()
        try:
            if prof is not None:
                with torch.profiler.record_function(tracing.IMAGE_SPAN):
                    out = call(pool[k % len(pool)], seed + k)
                traced.append(k)
            else:
                out = call(pool[k % len(pool)], seed + k)
        except Exception as e:  # noqa: BLE001 -- a failed image is counted, the loop goes on
            failures.append(f"image {k}: {type(e).__name__}: {e}")
            out = None
        now = time.perf_counter()
        lat.append(now - t)
        if out is not None:
            reservoir.offer(k, out)
        k += 1
        if (prof is not None and now - trace_t0 >= trace_plan["seconds"]
                and len(traced) >= trace_plan["min_images"]):
            synchronize(devices)
            prof.stop()
            prof, done = None, prof
        if now - t0 >= seconds and (not trace_plan or done is not None):
            break
    return lat, time.perf_counter() - t0, failures, done, tuple(traced)


def _reduce_profile(prof, traced: tuple, port_csrc: Path, cards: int) -> tracing.Trace:
    fd, path = tempfile.mkstemp(prefix="h100_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tracing.read_chrome_trace(Path(path))
    finally:
        os.remove(path)
    return tracing.reduce_trace(events, tracing.port_kernel_names(port_csrc), traced, cards)


def _check(entry, ref, samples, pool, cfg_r, seed: int, params: dict, device,
           limits: dict) -> tuple:
    """Each number of ``entry.compare`` over the sampled calls (the worst
    call), beside its limit; (correct, {name: (value, limit)})."""
    worst: dict = {}
    for k, got in sorted(samples, key=lambda kv: kv[0]):
        want = entry.call(ref, pool[k % len(pool)], cfg_r, seed + k, params, device)
        for name, value in entry.compare(got, want, pool[k % len(pool)]).items():
            if name not in worst or not value <= worst[name]:
                worst[name] = value
        del want
    checks = {name: (value, limits.get(name)) for name, value in sorted(worst.items())}
    ok = bool(checks) and all(lim is not None and value <= lim
                              for value, lim in checks.values())
    return ok, checks


def _number(v):
    """A JSON number, or a string for a value JSON cannot hold."""
    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) else str(v)


def count_jobs(entry, ref, pool: list, cfg_r, seed: int, params: dict, device):
    """call index -> ``counts.common.Job`` of the item that call encoded:
    its frames, the configuration, the content's counts from the reference
    (``entries/<entry>.run_members``, once a pool item)."""
    from ..counts.common import Job

    members: dict = {}

    def job(k: int):
        i = k % len(pool)
        if i not in members:
            members[i] = entry.run_members(ref, pool[i], cfg_r, seed + k, params, device)
        frames, h, w = item_frames(pool[i])
        return Job(h, w, cfg_r, int(params.get("num_levels", 1)), members[i], frames)

    return job


def run_cell(args, started: float, cell: spec.Cell | None = None,
             devices: tuple | None = None, program=None) -> tuple:
    """The run: (result dict, check lines). ``cell``, ``devices`` and
    ``program`` given (the harness's own tests) skip the look-up of the
    cell, the look for its cards and the import of the package."""
    import torch

    cell = spec.load_cell(args.workload) if cell is None else cell
    if devices is None:
        devices = cell_devices(cell.chips)
    cards = [d for d in devices if d.type == "cuda"]
    lib = program if program is not None else import_program(spec.ROOT)
    from .. import reference as ref

    entry = entries.load(cell.config)
    gen = spec.load_module("traffic", cell.traffic["generator"])
    device = call_device(devices)
    params = dict(cell.config.get("call", {}))
    cfg = entries.encode_config(lib, cell.config)
    settings = cell.settings

    # set-up: the pool, and every item once through the entry
    pool = gen.make_pool(cell.traffic, args.seed, device)
    pool_pixels = [item_pixels(item) for item in pool]

    def call(item, seed):
        return entry.call(lib, item, cfg, seed, params, device)

    for i, item in enumerate(pool):
        call(item, args.seed + WARM_SEED_OFFSET + i)
    synchronize(devices)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - started

    reservoir = Reservoir(int(settings.get("checked_images", 2)), args.seed)
    trace_plan = None
    if args.trace:
        trace_plan = dict(after_s=min(float(settings.get("trace_after_s", 2.0)), args.seconds / 3),
                          seconds=float(settings.get("trace_seconds", 2.0)),
                          min_images=int(settings.get("trace_min_images", 3)))
    lat, window_s, failures, prof, traced = _window(call, pool, args.seed, args.seconds,
                                                   reservoir, trace_plan, devices)
    synchronize(devices)
    peaks = [torch.cuda.max_memory_allocated(d) for d in cards] or [0] * len(devices)
    for d in cards:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    run = Run(setup_s=setup_s, latencies_s=lat, window_s=window_s,
              pixels=sum(pool_pixels[k % len(pool)] for k in range(len(lat))))
    if prof is not None:
        run.trace = _reduce_profile(prof, traced, Path(lib.__file__).parent / "csrc",
                                    len(devices))
        del prof

    # the check, on the reference
    cfg_r = entries.encode_config(ref, cell.config)
    correct, checks = _check(entry, ref, reservoir.items, pool, cfg_r, args.seed, params,
                             device, settings.get("limits", {}))
    correct = correct and not failures
    reservoir.items.clear()

    # work counts of the traced calls' items, for the counts' readers
    run.bound_jobs = count_jobs(entry, ref, pool, cfg_r, args.seed, params, device)
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = spec.load_module("metrics", m.name).read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}

    first = devices[0]    # the cards are alike: the first names them
    dev = {"platform": "gpu" if first.type == "cuda" else first.type,
           "kind": torch.cuda.get_device_name(first) if first.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(max(peaks)),
           "memory_peak_bytes_per_card": [int(p) for p in peaks]}
    result = {"correct": bool(correct), "attempted": len(lat), "failed": len(failures),
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["busy_s_per_card"] = list(run.trace.busy_s_per_card)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["check"] = {name: {"value": _number(v), "limit": _number(lim)}
                       for name, (v, lim) in checks.items()}
    lines = failures[:5] + [f"check {name}: {_number(v)} (limit {_number(lim)})"
                            for name, (v, lim) in checks.items()]
    lines.append(f"correct: {str(bool(correct)).lower()}")
    return result, lines


def emit(result: dict, lines: list, out=None, err=None) -> int:
    """Print a finished run: its check lines last on standard error, its
    result as the last line of standard output; nothing but a message
    (exit 3) where JAX or the JAX package is in the process."""
    out, err = out or sys.stdout, err or sys.stderr
    found = forbidden_modules()
    if found:
        err.write(f"h100_bench: forbidden modules in the process: {', '.join(found)}\n")
        return 3
    err.write("".join(line + "\n" for line in lines))
    err.flush()
    out.write(json.dumps(result, allow_nan=False) + "\n")
    out.flush()
    return 0


def main(argv, started: float | None = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse_args(argv)
    set_cache_dirs(spec.ROOT)
    try:
        result, lines = run_cell(args, started)
    except (Refused, spec.SpecError) as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    return emit(result, lines)
