"""Time the region-encode, quadtree fit, owner-crush, neighbour-match and
segment-encode kernels of limg_tpu_torch alone at 4K on one CUDA card,
beside a baseline build of the same kernels.

    python3 tools/profile_torch_kernels.py [--baseline DIR] [--out FILE] [--lane rgb]
                                           [--kernels-only] [--kernels REGEX]

Builds ``encode_fixed``, ``encode_region``, ``encode_merged``,
``encode_natural`` and ``coalesce`` from this checkout (and, with ``--baseline``, from the checkout at DIR into DIR's own
``build/kernels``) and prints what ``ptxas -v`` reports for every kernel:
registers, spill bytes, stack frame. Then, on the 4K RGB and RGBA test
images (tools/make_test_image.make_4k, error_factor 100, ladder K = 8):

- each kernel of this checkout against its plain version on the same
  inputs (bit-equal, as chip_smoke.py holds them);
- each kernel's time alone, CUDA events (median of 10 single calls after a
  warm-up, and the mean of 10 calls back to back, which hides the host's
  launch overhead) and torch.profiler device time of the kernel itself
  (mean over 5 calls; beside it the device busy time of the whole wrapper
  call, whose difference is the wrapper's copies) side by side:
  ``encode_fixed_p64`` on the fixed grid's 129,600 blocks and
  ``encode_region`` on the RD levels' 32,400 / 8,160 / 2,040 regions of
  256 / 1,024 / 4,096 pixels, each also with ``crush_mode="none"`` (which
  prices the search against the fit); ``fit_levels`` at 3 levels and at 2
  (the price of a level), ``fit_levels_natural``, ``owner_crush`` (ladder
  K = 8, and with ``crush_mode="none"``, which prices the search),
  ``owner_crush_natural``, ``match_neighbors`` on the default encode's
  level-0 and level-1 row planes, (7ch, 270, 480) and (7ch, 135, 240),
  and ``segment_encode`` on the default encode's
  run buffer, whole and cut to its member lanes (the price of the lanes
  that hold no run member); with a baseline, the two builds in turns
  (baseline, this, this, baseline);
- the run buffer's segment lengths (how many segments and 128-lane tiles
  hold more than 32 members), and how many blocks own at each level (the
  fit's ``owner``) and how many 3-level squares hold an owner of level 2;
- the fixed-grid step (``encode_perf_step``), the default merged step, the
  natural default step (``fused_merged_pre``, the capacity read,
  ``fused_merged_finish``) and the RD step (``fused_rd_pre``, the capacity
  read, ``fused_rd_finish``) by events and by the profiler's device busy
  time, with each build;
- the 4K encodes of the fixed grid and of every merged path (Morton with
  and without coalescing, natural, RD at 3 and 4 levels) with dithering
  off, with each build: PSNR, bpp, the decoded image's sum, and for the
  merged paths the runs and the blocks whose owner level differs from the
  JAX package's recorded default encode
  (tests/fixtures/torch_port_coalesce_reference.npz).

The baseline's kernels run through this checkout's wrappers (their C entry
points are unchanged), so both builds see the same inputs and glue. Writes
the numbers as JSON to FILE (default build/profile_kernels.json).
Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LIBRARIES = ("encode_fixed", "encode_region", "encode_merged", "encode_natural", "coalesce")
COALESCE_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_coalesce_reference.npz"
RUNS = 10
PROFILED = 5
RD_LAMBDA = 0.01


def log(*args):
    print(*args, flush=True)


def ptxas_lines(text: str) -> list[str]:
    """ptxas -v's report, one line per kernel: name<template arguments>,
    registers, stack frame, spill stores / loads."""
    out, name = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function .*?\d+([a-z][a-z0-9_]*_kernel)I((?:L[ib]\d+E)+)",
                      ln)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            name, frame, spill = f"{m.group(1)}<{args}>", "", ""
        elif name and "stack frame" in ln:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            frame, spill = m.group(1), f"{m.group(2)}/{m.group(3)}"
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, stack {frame or 0} B, spill stores/loads "
                       f"{spill or '0/0'} B")
            name = None
    return out


def build_baseline(checkout: Path) -> dict:
    """Compile the baseline checkout's libraries with this checkout's nvcc
    flags; {name: ctypes.CDLL}."""
    import ctypes

    from limg_tpu_torch.kernels.build import NVCC_FLAGS, find_nvcc, source_digest

    csrc = checkout / "limg_tpu_torch" / "csrc"
    out_dir = checkout / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()

    def one(name):
        # keyed by the baseline's sources, headers and the flags, as
        # kernels/build.py keys this checkout's libraries
        out = out_dir / f"lib{name}_baseline_{source_digest(name, csrc)}.so"
        log_file = out.with_suffix(".log")
        if not out.exists():
            src = csrc / f"{name}.cu"
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(out), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            log_file.write_text(proc.stdout + proc.stderr)
        return name, ctypes.CDLL(str(out)), log_file.read_text()

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(one, LIBRARIES))
    ptxas = {name: ptxas_lines(text) for name, _, text in built}
    return {name: lib for name, lib, _ in built}, ptxas


def declare(lib, name: str):
    """Give a baseline library the C signatures the wrappers declare."""
    import ctypes

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "encode_fixed":
        lib.limg_encode_fixed_p64.argtypes = [ptr, ptr] + [i32] * 8 + [ctypes.c_uint32] + [ptr] * 7
        fns = (lib.limg_encode_fixed_p64,)
    elif name == "encode_region":
        lib.limg_encode_region.argtypes = [ptr, ptr] + [i32] * 9 + [ctypes.c_uint32] + [ptr] * 7
        fns = (lib.limg_encode_region,)
    elif name == "encode_merged":
        lib.limg_fit_levels.argtypes = [ptr] + [i32] * 5 + [ptr] * 8
        lib.limg_owner_crush.argtypes = [ptr] + [i32] * 10 + [ctypes.c_uint32] + [ptr] * 10
        fns = (lib.limg_fit_levels, lib.limg_owner_crush)
    elif name == "encode_natural":
        lib.limg_fit_levels_natural.argtypes = [ptr] + [i32] * 5 + [ptr] * 8
        lib.limg_owner_crush_natural.argtypes = ([ptr] + [i32] * 10 + [ctypes.c_uint32]
                                                 + [ptr] * 10)
        fns = (lib.limg_fit_levels_natural, lib.limg_owner_crush_natural)
    else:
        lib.limg_match_pairs.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
        lib.limg_match_neighbors.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr]
        lib.limg_seg_scan_i32.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr]
        lib.limg_seg_scan_f32.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float, i32, ptr,
                                          ptr]
        lib.limg_segment_encode.argtypes = [ptr] * 4 + [i32] * 8 + [ctypes.c_uint32] + [ptr] * 10
        fns = (lib.limg_match_pairs, lib.limg_match_neighbors, lib.limg_seg_scan_i32,
               lib.limg_seg_scan_f32, lib.limg_segment_encode)
    for fn in fns:
        fn.restype = i32
    lib.limg_cuda_error_string.argtypes = [i32]
    lib.limg_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Builds:
    """Switches the wrappers between this checkout's libraries and the
    baseline's."""

    def __init__(self, baseline: dict | None):
        from limg_tpu_torch.kernels import coalesce, encode_fixed, encode_merged, encode_natural

        self.mods = {"encode_merged": encode_merged, "encode_natural": encode_natural,
                     "coalesce": coalesce}
        self.fixed = encode_fixed   # one accessor, _library(name), for two libraries
        self.own = {n: m._library for n, m in self.mods.items()}
        self.own_fixed = encode_fixed._library
        self.base = ({n: declare(lib, n) for n, lib in baseline.items()}
                     if baseline else None)

    def use(self, which: str):
        for n, m in self.mods.items():
            if which == "this":
                m._library = self.own[n]
            else:
                lib = self.base[n]
                m._library = lambda lib=lib: lib
        if which == "this":
            self.fixed._library = self.own_fixed
        else:
            self.fixed._library = lambda name, libs=self.base: libs[name]

    @property
    def names(self):
        return ("baseline", "this", "this", "baseline") if self.base else ("this", "this")


def events_ms(fn, device) -> tuple[float, float]:
    """(median ms of RUNS single calls, mean ms of RUNS calls back to back)."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(RUNS):
        fn()
    end.record()
    end.synchronize()
    return float(np.median(times)), start.elapsed_time(end) / RUNS


def profiled(fn, device, pattern: str | None) -> tuple[float, float]:
    """(device ms per call of the kernels whose name matches ``pattern``,
    device busy ms per call) by torch.profiler over PROFILED calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize(device)
    kern = busy = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        busy += e.self_device_time_total
        if pattern and re.search(pattern, e.key):
            kern += e.self_device_time_total
    return kern / PROFILED / 1e3, busy / PROFILED / 1e3


def segment_lengths(seg) -> dict:
    seg = seg.cpu().numpy()
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    lengths = np.diff(np.r_[starts, seg.size])
    tiles = set()
    for s, n in zip(starts, lengths):
        if n > 32:
            tiles.add(int(s) // 128)
    return {"segments": int(starts.size), "max": int(lengths.max()),
            "over_32": int((lengths > 32).sum()),
            "members_in_over_32": int(lengths[lengths > 32].sum()),
            "tiles": -(-seg.size // 128), "tiles_with_over_32": len(tiles)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="a checkout of the baseline tree")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "profile_kernels.json")
    ap.add_argument("--lane", choices=("rgb", "rgba"), action="append",
                    help="the image lanes to run (default both; torch.profiler drops the "
                         "kernel rows of a second lane in one process, so give one a run)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels alone and stop (no steps, no encodes)")
    ap.add_argument("--kernels", default="",
                    help="time only the kernel calls whose name matches this regular expression")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this tool needs a CUDA card")
    import limg_tpu_torch
    from chip_smoke import compare_outputs, image_run_buffer, run_text
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import build
    from limg_tpu_torch.encoder import _packed_blocks, encode_perf_step
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import encode_fixed as kf
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.regions import _words
    from tools.record_torch_reference import case_images

    device = torch.device("cuda", 0)
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log("card:", torch.cuda.get_device_name(0), "|", smi, "| torch", torch.__version__)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build.load_library, LIBRARIES))
    log(f"built {', '.join(LIBRARIES)} in {time.perf_counter() - t0:.1f} s")
    ptxas = {"this": {n: ptxas_lines(build.build_log.get(n, "")) for n in LIBRARIES}}
    baseline = None
    if args.baseline:
        baseline, ptxas["baseline"] = build_baseline(args.baseline.resolve())
    builds = Builds(baseline)
    for which, libs in ptxas.items():
        for name, lines in libs.items():
            for ln in lines:
                if re.search(r"encode_|fit_levels|owner_crush|match_", ln):
                    log(f"  ptxas {which} {name}: {ln}")
    result = {"card": smi, "ptxas": ptxas, "kernels": {}, "steps": {}, "encodes": {},
              "segments": {}, "owners": {}}
    fx = np.load(COALESCE_FIXTURE)
    images = case_images(2160, 3840)
    for lane, img in images.items():
        if args.lane and lane not in args.lane:
            continue
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        words = _words(img_d)
        builds.use("this")
        fit = km.fit_levels_kernel(words, cfg, 3)
        fit_n = kn.fit_levels_natural_kernel(words, cfg, 3)
        crush_args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, 3, 0)
        crush_n_args = (words, fit_n.owner, fit_n.f8_sel, fit_n.eps_sel, cfg, 3, 0)
        cfg_none = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", crush_mode="none")
        none_args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg_none, 3, 0)
        owners = torch.bincount(fit.owner.long(), minlength=3).tolist()
        top = fit.owner.reshape(270, 480)[::4, ::4]   # each 3-level square's first block
        result["owners"][lane] = {"blocks_per_level": owners,
                                  "squares_with_level_2": int((top == 2).sum()),
                                  "squares": int(top.numel())}
        log(f"  4K {lane} owner levels (blocks at 0 / 1 / 2): {owners}; squares owned at "
            f"level 2: {int((top == 2).sum())} of {int(top.numel())}")
        (packed, mask, seg, blocks), plane = image_run_buffer(
            img, EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False), device)
        planes = [plane.contiguous(), plane[:, ::2, ::2].contiguous()]
        members = int(mask.any(dim=0).sum())
        cut = tuple(t[..., :members].contiguous() for t in (packed, mask, seg, blocks))
        result["segments"][lane] = {**segment_lengths(seg), "lanes": int(seg.numel()),
                                    "member_lanes": members}
        log(f"  4K {lane} run buffer: {result['segments'][lane]}")
        # the fixed grid's blocks and the RD levels' regions, as the RD step
        # encodes them (endpoints emitted)
        regions = {64: _packed_blocks(img_d)[:2]}
        for side in (16, 32, 64):
            regions[side * side] = layout.blockify_words(words, side)[:2]
        region_calls, region_plain = {}, {}
        for p, (rp, rm) in regions.items():
            name = "encode_fixed_p64" if p == 64 else f"encode_region_p{p}"
            for tag, c in (("", cfg), (" crush none", cfg_none)):
                region_calls[name + tag] = (
                    lambda rp=rp, rm=rm, c=c: kf.encode_blocks_kernel(rp, rm, c, 0, True),
                    r"encode_(fixed_p64|region)_kernel")
                region_plain[name + tag] = (
                    lambda rp=rp, rm=rm, c=c: kf.encode_blocks_reference(rp, rm, c, 0, True))
        calls = {
            **region_calls,
            "fit_levels L3": (lambda: km.fit_levels_kernel(words, cfg, 3), r"fit_levels_kernel"),
            "fit_levels L2": (lambda: km.fit_levels_kernel(words, cfg, 2), r"fit_levels_kernel"),
            "fit_levels_natural L3": (lambda: kn.fit_levels_natural_kernel(words, cfg, 3),
                                      r"fit_levels_kernel"),
            "owner_crush L3": (lambda: km.owner_crush_kernel(*crush_args), r"owner_crush_kernel"),
            "owner_crush L3 crush none": (lambda: km.owner_crush_kernel(*none_args),
                                          r"owner_crush_kernel"),
            "owner_crush_natural L3": (lambda: kn.owner_crush_natural_kernel(*crush_n_args),
                                       r"owner_crush_kernel"),
            "match_neighbors level 0": (lambda: kc.match_neighbors_kernel(planes[0], cfg.channels),
                                        r"match_neighbors_kernel"),
            "match_neighbors level 1": (lambda: kc.match_neighbors_kernel(planes[1], cfg.channels),
                                        r"match_neighbors_kernel"),
            "segment_encode all lanes": (lambda: kc.segment_encode_kernel(packed, mask, seg,
                                                                          blocks, cfg, 0x5EED),
                                         r"segment_encode_kernel"),
            "segment_encode member lanes": (lambda: kc.segment_encode_kernel(*cut, cfg, 0x5EED),
                                            r"segment_encode_kernel"),
        }
        builds.use("this")
        plain = {
            **region_plain,
            "fit_levels L3": lambda: km.fit_levels_reference(words, cfg, 3),
            "fit_levels L2": lambda: km.fit_levels_reference(words, cfg, 2),
            "fit_levels_natural L3": lambda: kn.fit_levels_natural_reference(words, cfg, 3),
            "owner_crush L3": lambda: km.owner_crush_reference(*crush_args),
            "owner_crush L3 crush none": lambda: km.owner_crush_reference(*none_args),
            "owner_crush_natural L3": lambda: kn.owner_crush_natural_reference(*crush_n_args),
            "match_neighbors level 0": lambda: kc.match_neighbors_reference(planes[0],
                                                                           cfg.channels),
            "match_neighbors level 1": lambda: kc.match_neighbors_reference(planes[1],
                                                                           cfg.channels),
            "segment_encode all lanes": lambda: kc.segment_encode_reference(
                packed, mask, seg, blocks, cfg, 0x5EED),
            "segment_encode member lanes": lambda: kc.segment_encode_reference(*cut, cfg, 0x5EED),
        }
        chosen = [name for name in calls if re.search(args.kernels, name)]
        for name in chosen:
            got = calls[name][0]()
            torch.cuda.synchronize(device)
            compare_outputs(got, plain[name]())
        log(f"  4K {lane}: {len(chosen)} kernel calls bit-equal to their plain versions")
        for name in chosen:
            fn, pattern = calls[name]
            rows = []
            for which in builds.names:
                builds.use(which)
                ev, batch = events_ms(fn, device)
                kern, busy = profiled(fn, device, pattern)
                rows.append({"build": which, "events_ms": ev, "batch_ms": batch,
                             "profiler_ms": kern, "call_busy_ms": busy})
            result["kernels"][f"{lane} {name}"] = rows
            log(f"  4K {lane} {name}: " + ", ".join(
                f"{r['build']} {r['events_ms']!r} ms (back to back {r['batch_ms']!r}, profiler "
                f"{r['profiler_ms']!r}, call busy {r['call_busy_ms']!r})" for r in rows)
                + f" [{smi}]")

        if args.kernels_only:
            continue
        nb = 270 * 480

        def step(layout):
            state = limg_tpu_torch.fused_merged_pre(img_d, cfg, 0, 3, need_q=False, device=device,
                                                    fused_layout=layout)
            cap = limg_tpu_torch.auto_run_capacity(int(state["n_run_blocks"]), nb)
            out = limg_tpu_torch.fused_merged_finish(state, cfg, 0, 3, False, cap,
                                                     fused_layout=layout)
            return out["total_err"], out["mean_bpp"]

        def rd_step():
            state = limg_tpu_torch.fused_rd_pre(img_d, cfg, 0, RD_LAMBDA, 3, need_q=False,
                                                device=device)
            cap = limg_tpu_torch.auto_run_capacity(int(state["n_run_blocks"]), nb)
            out = limg_tpu_torch.fused_rd_finish(state, cfg, 0, RD_LAMBDA, 3, False, cap)
            return out["total_err"], out["mean_bpp"]

        steps = {"fixed-grid step": lambda: encode_perf_step(img_d, cfg, 0, device),
                 "default merged step": lambda: step("morton"),
                 "natural default step": lambda: step("natural"),
                 "RD step": rd_step}
        for name, fn in steps.items():
            rows = []
            for which in builds.names:
                builds.use(which)
                ev, _ = events_ms(fn, device)
                _, busy = profiled(fn, device, None)
                rows.append({"build": which, "events_ms": ev, "device_busy_ms": busy})
            result["steps"][f"{lane} {name}"] = rows
            log(f"  4K {lane} {name}: " + ", ".join(
                f"{r['build']} {r['events_ms']!r} ms (device busy {r['device_busy_ms']!r})"
                for r in rows) + f" [{smi}]")

        ref_owner = fx[f"4k_{lane}_l3.owner"]
        cfg0 = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False)
        rows = []
        for which in dict.fromkeys(builds.names):
            builds.use(which)
            out = limg_tpu_torch.encode_image(img, cfg0, device=device)
            rows.append({"build": which, "psnr": out["psnr"], "mean_bpp": out["mean_bpp"],
                         "decoded_sum": int(out["decoded"].astype(np.int64).sum())})
        result["encodes"][f"{lane} fixed grid"] = rows
        log(f"  4K {lane} fixed-grid encode (dithering off): " + "; ".join(
            f"{r['build']} psnr {r['psnr']!r} bpp {r['mean_bpp']!r} decoded sum "
            f"{r['decoded_sum']}" for r in rows))
        paths = {
            "morton default": dict(),
            "morton no coalescing": dict(coalesce=False),
            "natural default": dict(fused_layout="natural"),
            "rd": dict(merge_policy="rd", rd_lambda=RD_LAMBDA),
            "rd 4 levels": dict(merge_policy="rd", rd_lambda=RD_LAMBDA, num_levels=4),
        }
        for path, kw in paths.items():
            rows = []
            for which in dict.fromkeys(builds.names):
                builds.use(which)
                kw = {"num_levels": 3, **kw}
                out = limg_tpu_torch.encode_image_merged(img, cfg0, device=device, **kw)
                owner = out["owner_px"][::8, ::8].reshape(-1)
                rows.append({"build": which, "psnr": out["psnr"], "mean_bpp": out["mean_bpp"],
                             "n_runs": int(out["n_runs"]),
                             "owners_off_jax": int((owner != ref_owner).sum()),
                             "decoded_sum": int(out["decoded"].astype(np.int64).sum())})
            result["encodes"][f"{lane} {path}"] = rows
            log(f"  4K {lane} {path} encode (dithering off): " + "; ".join(
                f"{r['build']} psnr {r['psnr']!r} bpp {r['mean_bpp']!r} runs {r['n_runs']} "
                f"owners off JAX {r['owners_off_jax']} decoded sum {r['decoded_sum']}"
                for r in rows) + f" (JAX runs {int(fx[f'4k_{lane}_l3.n_runs'])})")
    builds.use("this")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
