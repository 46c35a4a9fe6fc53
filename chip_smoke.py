"""On-card smoke run of limg_tpu_torch: build, check and time the CUDA kernel,
and drive the fixed-grid encode (``limg_tpu_torch.encode_image``) on 4K
images through it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports neither JAX nor PIL. Phases:

0. environment: torch, CUDA, nvcc, Triton, the card's name and power limit;
1. build the kernel library from limg_tpu_torch/csrc/;
2. kernel vs its plain PyTorch version on the card (same inputs): integer
   outputs bit-equal, dist within 1e-6 relative, over images, channel
   counts, crush modes, num_factors and dithering;
3. the main path: ``encode_image`` on the 4K RGB and RGBA images, every
   kernel launch counted, stats held against the JAX package's recorded
   encode (tests/fixtures/torch_port_reference.json);
4. kernel and plain times at the main path's 4K shapes, CUDA events,
   median of 10 runs after warm-up.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_reference.json")
KERNEL_SOURCE = "limg_tpu_torch/csrc/encode_fixed.cu"
REPLACES = "limg_tpu/pallas_kernels/encode_fixed.py:808"
DIST_RTOL = 1e-6
# main-path tolerances against the JAX fixture
NODITHER_PSNR_DB, NODITHER_BPP, HIST_L1_FRAC = 0.02, 0.01, 0.005
DITHER_PSNR_DB, DITHER_BPP = 0.3, 0.1   # MULTICHIP_EXPECTED.json
TIMED_RUNS = 10


def log(*args):
    print(*args, flush=True)


def run_text(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def small_image(h: int = 40, w: int = 56, seed: int = 77) -> np.ndarray:
    """tests/conftest.make_test_image's recipe: gradients, an edge, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 40 + 150 * x / w + 8 * rng.standard_normal((h, w))
    g = 30 + 180 * y / h + 8 * rng.standard_normal((h, w))
    b = 128 + 90 * np.sin(x / 7.0) * np.cos(y / 5.0) + 8 * rng.standard_normal((h, w))
    img = np.stack([r, g, b, np.full((h, w), 255.0)], axis=-1)
    img[h // 3: h // 2, w // 4: w // 2, :3] = [220, 40, 180]
    return np.clip(img, 0, 255).astype(np.uint8)[..., :3]


def with_alpha(rgb: np.ndarray) -> np.ndarray:
    """RGB + bench.py's gradient alpha plane."""
    from tools.record_torch_reference import gradient_alpha

    h, w = rgb.shape[:2]
    return np.concatenate([rgb, gradient_alpha(h, w)[..., None]], axis=-1)


def phase_environment():
    import torch

    log("== phase 0: environment")
    log("python", sys.version.split()[0], "| torch", torch.__version__,
        "| torch.version.cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this run needs a CUDA card")
    from limg_tpu_torch.kernels.build import find_nvcc

    nvcc = find_nvcc()
    log("nvcc", nvcc, "|", run_text([nvcc, "--version"]).splitlines()[-1])
    try:
        import triton
        log("triton", triton.__version__)
    except ImportError:
        log("triton not importable")
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log("card:", torch.cuda.get_device_name(0), "| count", torch.cuda.device_count())
    return smi


def phase_build():
    from limg_tpu_torch.kernels import build

    log("== phase 1: build")
    t0 = time.perf_counter()
    build.load_library("encode_fixed")
    log(f"encode_fixed library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for line in build.build_log.get("encode_fixed", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas:", line.strip())


def compare_outputs(got, want) -> float:
    """Raise unless kernel outputs equal the plain version's; max abs diff."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"output {i}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        diff = (g.double() - w.double()).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        if g.dtype.is_floating_point:
            if not torch.isfinite(g).all():
                raise AssertionError(f"output {i}: non-finite values")
            bad = diff > DIST_RTOL * w.double().abs().clamp(min=1.0)
            if bad.any():
                raise AssertionError(f"output {i}: {int(bad.sum())} values beyond {DIST_RTOL} relative")
        elif not torch.equal(g, w):
            n = int((g != w).sum())
            raise AssertionError(f"output {i}: {n} of {g.numel()} values differ")
    return worst


def phase_compare(device, images=None) -> float:
    """Kernel vs plain version over the case grid; returns the max abs diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor, _packed_blocks
    from limg_tpu_torch.kernels.encode_fixed import (encode_blocks_kernel,
                                                     encode_blocks_reference)
    from tools.make_test_image import make_4k

    log("== phase 2: kernel vs plain version on the card")
    if images is None:
        rgb_small, rgb_mid = small_image(), make_4k(301, 437)
        images = {"40x56": rgb_small, "301x437": rgb_mid}
    settings = [(mode, 3, dith) for mode in ("ladder", "exhaustive", "guess", "none")
                for dith in (False, True)]
    settings += [("ladder", nf, dith) for nf in (1, 2) for dith in (False, True)]
    settings += [("exhaustive", 1, False), ("guess", 2, True)]
    worst, n_cases = 0.0, 0
    for name, rgb in images.items():
        for ch in (3, 4):
            img = _as_image_tensor(rgb if ch == 3 else with_alpha(rgb), device)
            packed, mask, _ = _packed_blocks(img)
            for mode, nf, dith in settings:
                cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                   dithering=dith, num_factors=nf)
                got = encode_blocks_kernel(packed, mask, cfg, 7, emit_endpoints=True)
                want = encode_blocks_reference(packed, mask, cfg, 7, emit_endpoints=True)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                try:
                    err = compare_outputs(got, want)
                except AssertionError as e:
                    raise AssertionError(f"{name} ch={ch} {mode} nf={nf} dither={dith}: {e}")
                worst = max(worst, err)
                n_cases += 1
        log(f"  {name}: {len(settings) * 2} cases bit-equal")
    log(f"phase 2 ok: {n_cases} cases, max abs diff {worst}")
    return worst


def check_against_fixture(name: str, out: dict, ref: dict, n_px: int):
    hist_l1 = int(np.abs(np.asarray(out["bits_histogram"]) - np.asarray(ref["bits_histogram"])).sum())
    d_psnr = out["psnr"] - ref["psnr"]
    d_bpp = out["mean_bpp"] - ref["mean_bpp"]
    log(f"  {name}: psnr {out['psnr']!r} (JAX {ref['psnr']!r}, diff {d_psnr:+.5f} dB) "
        f"bpp {out['mean_bpp']!r} (JAX {ref['mean_bpp']!r}, diff {d_bpp:+.5f}) "
        f"hist L1 {hist_l1} px ({hist_l1 / n_px:.5%})")
    if ref["dithering"]:
        ok = abs(d_psnr) <= DITHER_PSNR_DB and abs(d_bpp) <= DITHER_BPP
    else:
        ok = (abs(d_psnr) <= NODITHER_PSNR_DB and abs(d_bpp) <= NODITHER_BPP
              and hist_l1 <= HIST_L1_FRAC * n_px)
    if not ok:
        raise AssertionError(f"{name}: outside the tolerance of the JAX reference")


def phase_main_path(device, size: str = "4k"):
    """encode_image at real size through the kernel, against the fixture."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from tools.record_torch_reference import case_images

    log("== phase 3: main path (limg_tpu_torch.encode_image)")
    with open(FIXTURE) as f:
        cases = json.load(f)["cases"]
    h, w = cases[f"{size}_rgb_nodither"]["height"], cases[f"{size}_rgb_nodither"]["width"]
    images = case_images(h, w)
    kmod.launches = 0
    n_encodes = 0
    for lane, img in images.items():
        for dith in (False, True):
            name = f"{size}_{lane}_{'dither' if dith else 'nodither'}"
            cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
            before = kmod.launches
            t0 = time.perf_counter()
            out = limg_tpu_torch.encode_image(img, cfg, seed=0, device=device)
            secs = time.perf_counter() - t0
            n_encodes += 1
            if device.type == "cuda" and kmod.launches <= before:
                raise AssertionError(f"{name}: encode_image launched no kernel")
            dec = out["decoded"]
            if dec.shape != (h, w, 4) or not np.isfinite(out["psnr"]):
                raise AssertionError(f"{name}: decoded {dec.shape}, psnr {out['psnr']}")
            log(f"  {name}: encode_image {secs * 1e3:.1f} ms wall (host copies included)")
            check_against_fixture(name, out, cases[name], h * w)
    decoded, res, _ = limg_tpu_torch.encode_image_device(
        images["rgb"], EncodeConfig(error_factor=100), seed=0, device=device)
    if decoded.device.type != device.type or res.shifts.device.type != device.type:
        raise AssertionError(f"outputs on {decoded.device}, expected {device}")
    launched = kmod.launches
    log(f"phase 3 ok: {n_encodes + 1} encodes, {launched} kernel launches, outputs on {decoded.device}")
    return launched


def time_fn(fn, device, runs: int = TIMED_RUNS) -> float:
    """Median ms of ``runs`` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(device, smi: str):
    """Kernel and plain times at the 4K main-path shapes (also compared)."""
    import torch
    from limg_tpu_torch import EncodeConfig, encode_perf_step
    from limg_tpu_torch.encoder import _as_image_tensor, _packed_blocks
    from limg_tpu_torch.kernels.encode_fixed import (encode_blocks_kernel,
                                                     encode_blocks_reference)
    from tools.record_torch_reference import case_images

    log("== phase 4: timing at 4K (CUDA events, median of", TIMED_RUNS, "runs)")
    images = case_images(2160, 3840)
    rows, worst = {}, 0.0
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        packed, mask, _ = _packed_blocks(img_d)
        worst = max(worst, compare_outputs(
            encode_blocks_kernel(packed, mask, cfg, 0, emit_endpoints=True),
            encode_blocks_reference(packed, mask, cfg, 0, emit_endpoints=True)))
        # plain, kernel, kernel, plain: both see the same card state
        p1 = time_fn(lambda: encode_blocks_reference(packed, mask, cfg, 0), device)
        k1 = time_fn(lambda: encode_blocks_kernel(packed, mask, cfg, 0), device)
        k2 = time_fn(lambda: encode_blocks_kernel(packed, mask, cfg, 0), device)
        p2 = time_fn(lambda: encode_blocks_reference(packed, mask, cfg, 0), device)
        step = time_fn(lambda: encode_perf_step(img_d, cfg, 0, device), device)
        mpx = img.shape[0] * img.shape[1] * 1e-6
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        rows[lane] = (k_ms, p_ms)
        log(f"  4K {lane}: kernel {k1!r} / {k2!r} ms ({mpx / k_ms * 1e3!r} Mpx/s), "
            f"plain {p1!r} / {p2!r} ms ({mpx / p_ms * 1e3!r} Mpx/s); "
            f"encode_perf_step {step!r} ms = {mpx / step * 1e3!r} Mpx/s [{smi}]")
        profile_step(lambda: encode_perf_step(img_d, cfg, 0, device), device, lane)
    log(f"phase 4 ok: 4K kernel outputs equal the plain version's (max abs diff {worst})")
    return rows, worst


def profile_step(fn, device, lane: str, iters: int = 5):
    """Device time by operation over ``iters`` perf steps (torch.profiler),
    and the device-busy share of the profiled window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):   # the first window pays the profiler's start-up
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    # device-side events only (CPU ops would count their kernels twice)
    rows = sorted(((e.key, e.self_device_time_total / iters) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(us for _, us in rows)
    log(f"  profile 4K {lane} perf step: device busy {busy!r} us of {wall_us!r} us wall "
        f"per step, idle share {1 - busy / wall_us!r} (profiler on)")
    for key, us in rows[:8]:
        log(f"    {us!r:>22} us  {key[:90]}")


def main():
    sys.path.insert(0, ROOT)
    import torch

    smi = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    worst = phase_compare(device)
    launched = phase_main_path(device)
    rows, worst4k = phase_timing(device, smi)
    k_ms, p_ms = rows["rgb"]     # the 4K RGB lane; RGBA is printed above
    log(json.dumps({"kernels": [{
        "name": "encode_fixed_p64", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launched, "max_abs_err": max(worst, worst4k),
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
