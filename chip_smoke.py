"""On-card smoke run of limg_tpu_torch: build, check and time the CUDA
kernels, and drive the fixed-grid encode (``limg_tpu_torch.encode_image``),
the quadtree-merged encode without coalescing
(``encode_image_merged(..., coalesce=False)``) and the default merged
encode with run coalescing (``encode_image_merged()``, and the CLI's merged
mode) on 4K images through them.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports neither JAX nor PIL. Phases:

0. environment: torch, CUDA, nvcc, Triton, the card's name and power limit;
1. build the kernel libraries from limg_tpu_torch/csrc/, one nvcc per
   source, all started together;
2. ``encode_fixed_p64`` vs its plain PyTorch version on the card (same
   inputs): integer outputs bit-equal, dist within 1e-6 relative, over
   images, channel counts, crush modes, num_factors and dithering;
2b. the same for ``fit_levels`` and ``owner_crush`` over levels 2 to 4,
   RGB and RGBA, aligned and edge-padded images, and the same settings;
2c. the same for the four run-coalescing kernels (``match_pairs``,
   ``match_neighbors``, ``seg_mixed_all``, ``segment_encode``) on seeded and
   fitted rows, random and real segment maps, RGB and RGBA, every crush
   mode, num_factors 1-3, dithering off and on;
3. the fixed-grid path: ``encode_image`` on the 4K RGB and RGBA images,
   its kernel's launches counted from 0, stats held against the JAX
   package's recorded encode (tests/fixtures/torch_port_reference.json);
3b. the merged path without coalescing: ``encode_image_merged(coalesce=
   False)`` on the same images, both kernels' launches counted from 0, held
   against the JAX fused path's recorded encode (tests/fixtures/
   torch_port_merged_reference.npz);
3c. the default merged path: ``encode_image_merged()`` on the same images,
   the launches of all six merged-path kernels counted from 0, held against
   the JAX default encode (tests/fixtures/torch_port_coalesce_reference.npz),
   then the CLI's merged mode once;
4. / 4b. / 4c. kernel and plain times at the 4K shapes of each path, and
   each path's device-resident step, CUDA events, median of 10 runs after
   warm-up, with a torch.profiler breakdown.

Prints one JSON line of kernel results, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_reference.json")
MERGED_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_merged_reference.npz")
COALESCE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_coalesce_reference.npz")
LIBRARIES = ("encode_fixed", "encode_merged", "coalesce")
KERNEL_SOURCE = "limg_tpu_torch/csrc/encode_fixed.cu"
REPLACES = "limg_tpu/pallas_kernels/encode_fixed.py:808"
MERGED_SOURCE = "limg_tpu_torch/csrc/encode_merged.cu"
MERGED_REPLACES = {"fit_levels": "limg_tpu/pallas_kernels/encode_merged.py:813",
                   "owner_crush": "limg_tpu/pallas_kernels/encode_merged.py:902"}
COALESCE_SOURCE = "limg_tpu_torch/csrc/coalesce.cu"
COALESCE_REPLACES = {
    "match_neighbors": "limg_tpu/pallas_kernels/encode_merged.py:587",
    "match_pairs": "limg_tpu/pallas_kernels/encode_merged.py:516",
    "seg_mixed_all": "limg_tpu/pallas_kernels/seg_scan.py:140",
    "segment_encode": "limg_tpu/pallas_kernels/encode_segments.py:188",
}
MERGED_LEVELS = 3
DIST_RTOL = 1e-6
# main-path tolerances against the JAX fixture
NODITHER_PSNR_DB, NODITHER_BPP, HIST_L1_FRAC = 0.02, 0.01, 0.005
DITHER_PSNR_DB, DITHER_BPP = 0.3, 0.1   # MULTICHIP_EXPECTED.json
ALIVE_FRAC, OWNER_AGREE = 0.005, 0.995  # merged: per-level counts, per-block owners
RUNS_FRAC = 0.02                        # coalesced: n_runs
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
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build.load_library, LIBRARIES))
    log(f"{', '.join(LIBRARIES)} libraries ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name in LIBRARIES:
        for line in build.build_log.get(name, "").splitlines():
            if ("entry function" in line or "registers" in line or "spill" in line
                    or "error" in line.lower()):
                log(f"  ptxas {name}:", line.strip())


def compare_outputs(got, want) -> float:
    """Raise unless kernel outputs equal the plain version's; max abs diff."""
    import torch

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            if g is not w:
                raise AssertionError(f"output {i}: {g} vs {w}")
            continue
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


SETTINGS = ([(mode, 3, dith) for mode in ("ladder", "exhaustive", "guess", "none")
             for dith in (False, True)]
            + [("ladder", nf, dith) for nf in (1, 2) for dith in (False, True)]
            + [("exhaustive", 1, False), ("guess", 2, True)])


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
    settings = SETTINGS
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


def phase_compare_merged(device, images=None) -> float:
    """fit_levels and owner_crush vs their plain versions; max abs diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.regions import _words
    from tools.make_test_image import make_4k

    log("== phase 2b: fused quadtree kernels vs plain versions on the card")
    if images is None:
        images = {"256x384": make_4k(256, 384), "70x90": small_image(70, 90),
                  "301x437": make_4k(301, 437)}
    worst, n_cases = 0.0, 0
    for name, rgb in images.items():
        for ch in (3, 4):
            words = _words(_as_image_tensor(rgb if ch == 3 else with_alpha(rgb), device))
            for levels in (2, 3, 4):
                for mode, nf, dith in SETTINGS:
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    case = f"{name} ch={ch} levels={levels} {mode} nf={nf} dither={dith}"
                    fit = km.fit_levels_reference(words, cfg, levels)
                    args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, levels, 7)
                    got_fit = km.fit_levels_kernel(words, cfg, levels)
                    got_crush = km.owner_crush_kernel(*args)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    try:
                        worst = max(worst, compare_outputs(got_fit, fit),
                                    compare_outputs(got_crush, km.owner_crush_reference(*args)))
                    except AssertionError as e:
                        raise AssertionError(f"{case}: {e}")
                    n_cases += 1
        log(f"  {name}: {2 * 3 * len(SETTINGS)} cases bit-equal (fit and crush)")
    log(f"phase 2b ok: {n_cases} cases, max abs diff {worst}")
    return worst


def seg_map(rng, n: int, max_span: int = 256) -> np.ndarray:
    """Contiguous segments, ids = first positions, spans 1..max_span."""
    seg = np.empty(n, np.int32)
    i = 0
    while i < n:
        span = int(rng.integers(1, min(max_span, n - i) + 1))
        seg[i:i + span] = i
        i += span
    return seg


def seeded_rows(rng, n: int, ch: int) -> np.ndarray:
    """(7ch, n) float32 Decomposition rows in the fit's ranges, some flat."""
    avg = rng.uniform(0, 255, (ch, n))
    lo = rng.integers(-30, 200, (ch, n))
    rows = [avg, lo, lo + rng.integers(0, 120, (ch, n))]
    for span, width in ((40, 60), (20, 30)):
        off = rng.integers(-span, span, (ch, n))
        rows += [off, off + rng.integers(0, width, (ch, n))]
    flat = rng.random(n) < 0.3
    for r in rows[1:]:
        r[:, flat] = r[:, flat] // 8 * 8
    return np.concatenate(rows, axis=0).astype(np.float32)


def seeded_run_buffer(rng, n: int, ch: int, device):
    """A run buffer of random pixels: half smooth, some empty and some
    half-empty blocks, segments of 1-256 blocks, shuffled block indices."""
    import torch

    px = rng.integers(0, 256, (4, 64, n), np.int64)
    px[:, :, : n // 2] = (px[:, :, : n // 2] // 32) * 32
    if ch == 3:
        px[3] = 0
    mask = np.ones((64, n), bool)
    mask[:, rng.integers(0, n, n // 10)] = False
    mask[32:, rng.integers(0, n, n // 10)] = False
    words = px[0] | (px[1] << 8) | (px[2] << 16) | (px[3] << 24)
    words = np.where(words >= 2**31, words - 2**32, words).astype(np.int32)
    blocks = rng.permutation(4 * n)[:n].astype(np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (words, mask, seg_map(rng, n), blocks))


def image_run_buffer(img, cfg, device, levels: int = MERGED_LEVELS):
    """The run buffer of one image as the default encode builds it, and the
    owner-selected (7ch, by, bx) rows its run building matched on."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch.regions import compact_runs

    state = limg_tpu_torch.fused_merged_pre(img, cfg, num_levels=levels, need_q=False,
                                            device=device)
    nb = state["seg0"].numel()
    order, seg_c = compact_runs(state["seg0"], state["is_run0"], nb)
    mask = state["mask"][:, order] & state["is_run0"][order][None]
    buf = (state["px"][:, order].contiguous(), mask.contiguous(), seg_c, order.to(torch.int32))
    fit, grid = state["fit"], state["grid"]
    rows = torch.cat([fit.avg_sel, fit.eps_sel.reshape(-1, nb).to(torch.float32)])
    return buf, rows.reshape(-1, grid.blocks_y, grid.blocks_x)


COALESCE_SETTINGS_SEEDED = [("ladder", 3, False), ("ladder", 3, True), ("exhaustive", 1, False),
                            ("guess", 2, True), ("none", 3, False), ("ladder", 2, True)]


def phase_compare_coalesce(device, images=None) -> float:
    """The four run-coalescing kernels vs their plain versions; max abs diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.kernels import coalesce as kc
    from tools.make_test_image import make_4k

    log("== phase 2c: run-coalescing kernels vs plain versions on the card")
    if images is None:
        images = {"256x384": make_4k(256, 384), "301x437": make_4k(301, 437)}
    rng = np.random.default_rng(2024)
    worst, n_cases = 0.0, 0

    def check(case, got, want):
        nonlocal worst, n_cases
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        try:
            worst = max(worst, compare_outputs(got, want))
        except AssertionError as e:
            raise AssertionError(f"{case}: {e}")
        n_cases += 1

    # match kernels on seeded rows (below and above one CTA's pairs)
    for ch in (3, 4):
        for n in (5, 3000):
            a = torch.from_numpy(seeded_rows(rng, n, ch)).to(device)
            b = a + (torch.rand(a.shape, device=device) < 0.3) * torch.randint(
                0, 6, a.shape, device=device)
            check(f"match_pairs seeded ch={ch} n={n}", [kc.match_pairs_kernel(a, b, ch)],
                  [kc.match_pairs_reference(a, b, ch)])
        for by, bx in ((37, 150), (1, 70), (40, 1), (130, 130)):
            plane = torch.from_numpy(seeded_rows(rng, by * bx, ch)).to(device).reshape(-1, by, bx)
            check(f"match_neighbors seeded ch={ch} {by}x{bx}",
                  kc.match_neighbors_kernel(plane, ch), kc.match_neighbors_reference(plane, ch))
    # the scan on random segment maps, int and float rows, every row mix
    for n in (1, 1000, 5000, 129600):
        seg = torch.from_numpy(seg_map(rng, n)).to(device)
        xi = torch.from_numpy(rng.integers(-2**20, 2**20, (3, n)).astype(np.int32)).to(device)
        xf = torch.from_numpy((rng.standard_normal((3, n)) * 100).astype(np.float32)).to(device)
        for x in (xi, xf):
            for n_sum in (0, 1, 3):
                check(f"seg_mixed_all n={n} {x.dtype} n_sum={n_sum}",
                      [kc.seg_mixed_all_kernel(x, seg, n_sum)],
                      [kc.seg_mixed_all_reference(x, seg, n_sum)])
    # segment encode on seeded buffers (below and above one CTA's lanes)
    for ch in (3, 4):
        for n in (100, 1500):
            buf = seeded_run_buffer(rng, n, ch, device)
            for mode, nf, dith in COALESCE_SETTINGS_SEEDED:
                cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                   dithering=dith, num_factors=nf)
                check(f"segment_encode seeded ch={ch} n={n} {mode} nf={nf} dither={dith}",
                      kc.segment_encode_kernel(*buf, cfg, 0x5EED),
                      kc.segment_encode_reference(*buf, cfg, 0x5EED))
    log(f"  seeded: {n_cases} cases bit-equal")
    # real run buffers and fitted rows of edge-padded and aligned images
    for name, rgb in images.items():
        for ch in (3, 4):
            img = rgb if ch == 3 else with_alpha(rgb)
            buf, plane = image_run_buffer(img, EncodeConfig(error_factor=100, has_alpha=ch == 4,
                                                            dithering=False), device)
            for lvl in range(MERGED_LEVELS):
                p = plane[:, ::1 << lvl, ::1 << lvl].contiguous()
                check(f"{name} ch={ch} match_neighbors level {lvl}",
                      kc.match_neighbors_kernel(p, ch), kc.match_neighbors_reference(p, ch))
                a, b = p[:, :, 1:].reshape(7 * ch, -1), p[:, :, :-1].reshape(7 * ch, -1)
                check(f"{name} ch={ch} match_pairs level {lvl}", [kc.match_pairs_kernel(a, b, ch)],
                      [kc.match_pairs_reference(a, b, ch)])
            rows = torch.stack([buf[1].sum(dim=0, dtype=torch.int32), buf[3]])
            check(f"{name} ch={ch} seg_mixed_all on the run buffer",
                  [kc.seg_mixed_all_kernel(rows, buf[2], 2)],
                  [kc.seg_mixed_all_reference(rows, buf[2], 2)])
            for mode, nf, dith in SETTINGS:
                cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                   dithering=dith, num_factors=nf)
                check(f"{name} ch={ch} segment_encode {mode} nf={nf} dither={dith}",
                      kc.segment_encode_kernel(*buf, cfg, 0x5EED),
                      kc.segment_encode_reference(*buf, cfg, 0x5EED))
        log(f"  {name}: real run buffers and fitted rows bit-equal")
    log(f"phase 2c ok: {n_cases} cases, max abs diff {worst}")
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

    log("== phase 3: fixed-grid path (limg_tpu_torch.encode_image)")
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
    if launched == 0:
        raise AssertionError("the fixed-grid path launched no encode_fixed_p64 kernel")
    log(f"phase 3 ok: {n_encodes + 1} encodes, {launched} kernel launches, outputs on {decoded.device}")
    return launched


def check_merged_against_fixture(name: str, out: dict, fx, n_px: int, dithering: bool):
    """Stats of one 4K merged encode against the JAX fused (or, with
    dithering, dense) path's recorded ones."""
    if dithering:
        ref_psnr = float(fx[f"{name}_dither_dense.psnr"])
        ref_bpp = float(fx[f"{name}_dither_dense.mean_bpp"])
    else:
        ref_psnr, ref_bpp = float(fx[f"{name}.psnr"]), float(fx[f"{name}.mean_bpp"])
    d_psnr, d_bpp = out["psnr"] - ref_psnr, out["mean_bpp"] - ref_bpp
    msg = (f"  {name} dither={dithering}: psnr {out['psnr']!r} (JAX {ref_psnr!r}, "
           f"diff {d_psnr:+.5f} dB) bpp {out['mean_bpp']!r} (JAX {ref_bpp!r}, diff {d_bpp:+.5f}) "
           f"alive {out['alive_counts'].tolist()}")
    if dithering:
        log(msg)
        if abs(d_psnr) > DITHER_PSNR_DB or abs(d_bpp) > DITHER_BPP:
            raise AssertionError(f"{name} dither: outside the tolerance of the dense reference")
        return
    hist_l1 = int(np.abs(out["bits_histogram"] - fx[f"{name}.bits_histogram"]).sum())
    ref_alive = fx[f"{name}.alive_counts"]
    alive_rel = np.abs(out["alive_counts"] - ref_alive) / np.maximum(ref_alive, 1)
    owner = out["owner_px"][::8, ::8].reshape(-1)
    agree = float((owner == fx[f"{name}.owner"]).mean())
    log(msg + f" (JAX {ref_alive.tolist()}), hist L1 {hist_l1} px ({hist_l1 / n_px:.5%}), "
        f"owner agreement {agree!r}")
    if not (abs(d_psnr) <= NODITHER_PSNR_DB and abs(d_bpp) <= NODITHER_BPP
            and hist_l1 <= HIST_L1_FRAC * n_px and (alive_rel <= ALIVE_FRAC).all()
            and agree >= OWNER_AGREE):
        raise AssertionError(f"{name}: outside the tolerance of the JAX fused path")


def phase_main_path_merged(device):
    """encode_image_merged(coalesce=False) at 4K through both kernels."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import encode_merged as km
    from tools.record_torch_reference import case_images

    log("== phase 3b: merged path (limg_tpu_torch.encode_image_merged, coalesce=False)")
    fx = np.load(MERGED_FIXTURE)
    h, w = 2160, 3840
    images = case_images(h, w)
    for k in km.launches:
        km.launches[k] = 0
    n_encodes = 0
    for lane, img in images.items():
        for dith in (False, True):
            cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
            t0 = time.perf_counter()
            out = limg_tpu_torch.encode_image_merged(img, cfg, seed=0, num_levels=MERGED_LEVELS,
                                                     coalesce=False, device=device)
            secs = time.perf_counter() - t0
            n_encodes += 1
            dec = out["decoded"]
            if dec.shape != (h, w, 4) or not np.isfinite(out["psnr"]):
                raise AssertionError(f"{lane}: decoded {dec.shape}, psnr {out['psnr']}")
            log(f"  4k_{lane} dither={dith}: encode_image_merged {secs * 1e3:.1f} ms wall "
                f"(host copies included)")
            check_merged_against_fixture(f"4k_{lane}_l{MERGED_LEVELS}", out, fx, h * w, dith)
    dev_out = limg_tpu_torch.encode_image_merged_fused_device(
        images["rgb"], EncodeConfig(error_factor=100), seed=0, num_levels=MERGED_LEVELS,
        coalesce=False, device=device)
    for key in ("decoded", "bits_histogram", "factors_pnb", "block_rows8"):
        if dev_out[key].device.type != device.type:
            raise AssertionError(f"{key} on {dev_out[key].device}, expected {device}")
    launched = dict(km.launches)
    if min(launched.values()) == 0:
        raise AssertionError(f"the merged path skipped a kernel: launches {launched}")
    log(f"phase 3b ok: {n_encodes + 1} encodes, launches {launched}, outputs on "
        f"{dev_out['decoded'].device}")
    return launched


def check_coalesced_against_fixture(name: str, out: dict, fx, n_px: int, dithering: bool):
    """Stats of one 4K default merged encode against the JAX default
    encode's recorded ones. No JAX path runs the fused coalesced encode
    with dithering on the CPU, so a dithered encode is held against the
    recorded PSNR less JAX's own dither penalty on the same image (its
    dense dithered encode against its fused undithered one, coalescing off,
    tests/fixtures/torch_port_merged_reference.npz), and against the
    recorded bpp, which dithering does not change."""
    ref_psnr, ref_bpp = float(fx[f"{name}.psnr"]), float(fx[f"{name}.mean_bpp"])
    if dithering:
        mfx = np.load(MERGED_FIXTURE)
        ref_psnr += float(mfx[f"{name}_dither_dense.psnr"]) - float(mfx[f"{name}.psnr"])
    d_psnr, d_bpp = out["psnr"] - ref_psnr, out["mean_bpp"] - ref_bpp
    st = [out["coalesce_stats"][k] for k in ("dropped_runs_at_capacity", "overflow_run_blocks",
                                             "rejected_runs")]
    ref_runs = int(fx[f"{name}.n_runs"])
    msg = (f"  {name} dither={dithering}: psnr {out['psnr']!r} (JAX {ref_psnr!r}, diff "
           f"{d_psnr:+.5f} dB) bpp {out['mean_bpp']!r} (JAX {ref_bpp!r}, diff {d_bpp:+.5f}) "
           f"runs {out['n_runs']} (JAX {ref_runs}) stats {st} "
           f"(JAX {fx[f'{name}.coalesce_stats'].tolist()})")
    if st[:2] != [0, 0]:
        raise AssertionError(f"{name}: auto capacity dropped runs: {st}")
    if dithering:
        log(msg)
        if abs(d_psnr) > DITHER_PSNR_DB or abs(d_bpp) > DITHER_BPP:
            raise AssertionError(f"{name} dither: outside the tolerance of the JAX reference")
        return
    hist_l1 = int(np.abs(out["bits_histogram"] - fx[f"{name}.bits_histogram"]).sum())
    ref_alive = fx[f"{name}.alive_counts"]
    alive_rel = np.abs(out["alive_counts"] - ref_alive) / np.maximum(ref_alive, 1)
    owner = out["owner_px"][::8, ::8].reshape(-1)
    agree = float((owner == fx[f"{name}.owner"]).mean())
    log(msg + f" alive {out['alive_counts'].tolist()} (JAX {ref_alive.tolist()}), hist L1 "
        f"{hist_l1} px ({hist_l1 / n_px:.5%}), owner agreement {agree!r}")
    if not (abs(d_psnr) <= NODITHER_PSNR_DB and abs(d_bpp) <= NODITHER_BPP
            and hist_l1 <= HIST_L1_FRAC * n_px and (alive_rel <= ALIVE_FRAC).all()
            and agree >= OWNER_AGREE and abs(out["n_runs"] - ref_runs) <= RUNS_FRAC * ref_runs):
        raise AssertionError(f"{name}: outside the tolerance of the JAX default encode")


def reset_launches():
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import encode_merged as km

    for counts in (km.launches, kc.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import encode_merged as km

    return {**km.launches, **kc.launches}


def phase_main_path_coalesce(device):
    """encode_image_merged() with its defaults at 4K through all six
    merged-path kernels, then the CLI's merged mode."""
    import contextlib
    import io
    import tempfile

    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig, cli
    from tools.record_torch_reference import case_images

    log("== phase 3c: default merged path (limg_tpu_torch.encode_image_merged(), coalescing on)")
    fx = np.load(COALESCE_FIXTURE)
    h, w = 2160, 3840
    images = case_images(h, w)
    reset_launches()
    n_encodes = 0
    for lane, img in images.items():
        for dith in (False, True):
            cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
            t0 = time.perf_counter()
            out = limg_tpu_torch.encode_image_merged(img, cfg, device=device)
            secs = time.perf_counter() - t0
            n_encodes += 1
            dec = out["decoded"]
            if dec.shape != (h, w, 4) or not np.isfinite(out["psnr"]) or out["n_runs"] <= 0:
                raise AssertionError(f"{lane}: decoded {dec.shape}, psnr {out['psnr']}, "
                                     f"runs {out['n_runs']}")
            log(f"  4k_{lane} dither={dith}: encode_image_merged {secs * 1e3:.1f} ms wall "
                f"(host copies included)")
            check_coalesced_against_fixture(f"4k_{lane}_l{MERGED_LEVELS}", out, fx, h * w, dith)
    launched = read_launches()
    if min(launched.values()) == 0:
        raise AssertionError(f"the default merged path skipped a kernel: launches {launched}")
    log(f"  {n_encodes} encodes, launches {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "img4k.npy")
        np.save(npy, images["rgb"])
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main([npy, "--no-output"])
    lines = [ln for ln in text.getvalue().splitlines()
             if ln.startswith(("limg_tpu_torch", "Elapsed", "Compression", "Image Perceptual"))]
    if len(lines) != 4:
        raise AssertionError(f"the CLI's merged mode printed {text.getvalue()!r}")
    for ln in lines:
        log(f"  cli: {ln}")
    log("phase 3c ok")
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


def phase_timing_merged(device, smi: str):
    """fit_levels / owner_crush vs plain, and the device-resident merged step,
    at 4K (also compared)."""
    from limg_tpu_torch import EncodeConfig, encode_image_merged_fused_device
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.regions import _words
    from tools.record_torch_reference import case_images

    log("== phase 4b: merged kernels at 4K (CUDA events, median of", TIMED_RUNS, "runs)")
    images = case_images(2160, 3840)
    rows, worst, lv = {}, 0.0, MERGED_LEVELS
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        words = _words(img_d)
        fit = km.fit_levels_reference(words, cfg, lv)
        worst = max(worst, compare_outputs(km.fit_levels_kernel(words, cfg, lv), fit))
        args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, lv, 0)
        worst = max(worst, compare_outputs(km.owner_crush_kernel(*args),
                                           km.owner_crush_reference(*args)))
        fns = {"fit_levels": (lambda: km.fit_levels_kernel(words, cfg, lv),
                              lambda: km.fit_levels_reference(words, cfg, lv)),
               "owner_crush": (lambda: km.owner_crush_kernel(*args),
                               lambda: km.owner_crush_reference(*args))}
        mpx = img.shape[0] * img.shape[1] * 1e-6
        for name, (kern, plain) in fns.items():
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
            rows[(name, lane)] = (min(k1, k2), min(p1, p2))
            log(f"  4K {lane} {name}: kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms [{smi}]")

        def step():
            out = encode_image_merged_fused_device(img_d, cfg, 0, lv, emit_planes=False,
                                                   coalesce=False, device=device)
            return out["total_err"], out["mean_bpp"]

        step_ms = time_fn(step, device)
        log(f"  4K {lane} merged step (encode_image_merged_fused_device, emit_planes=False): "
            f"{step_ms!r} ms = {mpx / step_ms * 1e3!r} Mpx/s [{smi}]")
        profile_step(step, device, f"{lane} merged")
    log(f"phase 4b ok: 4K merged kernel outputs equal the plain versions' (max abs diff {worst})")
    return rows, worst


def capture_coalesce_calls(fn) -> dict:
    """Run ``fn`` with the four run-coalescing wrappers recording their
    arguments: {wrapper name: [args, ...]}."""
    from limg_tpu_torch import regions
    from limg_tpu_torch.kernels import coalesce as kc

    names = ("match_neighbors_kernel", "match_pairs_kernel", "seg_mixed_all_kernel",
             "segment_encode_kernel")
    calls, saved = {n: [] for n in names}, {n: getattr(kc, n) for n in names}

    def spy(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return call

    try:
        for n in names:
            setattr(kc, n, spy(n))
            setattr(regions, n, getattr(kc, n))
        fn()
    finally:
        for n in names:
            setattr(kc, n, saved[n])
            setattr(regions, n, saved[n])
    return calls


def phase_timing_coalesce(device, smi: str):
    """The four run-coalescing kernels vs plain at the 4K main-path shapes
    (also compared), and the default merged step."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import coalesce as kc
    from tools.record_torch_reference import case_images

    log("== phase 4c: run-coalescing kernels at 4K (CUDA events, median of", TIMED_RUNS, "runs)")
    images = case_images(2160, 3840)
    rows, worst, lv = {}, 0.0, MERGED_LEVELS
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        calls = capture_coalesce_calls(
            lambda: limg_tpu_torch.encode_image_merged(img_d, cfg, fetch_planes=False,
                                                       device=device))
        # the main path's first calls: level 0's neighbour plane, the one
        # pair launch (level 2 at 4K), level 0's run-length scan (129,600
        # lanes), the full-capacity segment encode
        shapes = {
            "match_neighbors": calls["match_neighbors_kernel"][0],
            "match_pairs": calls["match_pairs_kernel"][0],
            "seg_mixed_all": calls["seg_mixed_all_kernel"][0],
            "segment_encode": calls["segment_encode_kernel"][0],
        }
        log(f"  4K {lane} main-path calls: " + ", ".join(
            f"{k} {len(v)}" for k, v in calls.items()) + "; timed shapes: "
            + ", ".join(f"{k} {tuple(c[0][0].shape)}" for k, c in shapes.items()))
        mpx = img.shape[0] * img.shape[1] * 1e-6
        for name, (args, kwargs) in shapes.items():
            kern = getattr(kc, f"{name}_kernel")
            plain = getattr(kc, f"{name}_reference")
            got, want = kern(*args, **kwargs), plain(*args, **kwargs)
            worst = max(worst, compare_outputs(got if isinstance(got, tuple) else [got],
                                               want if isinstance(want, tuple) else [want]))
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (time_fn(lambda f=f: f(*args, **kwargs), device)
                              for f in (plain, kern, kern, plain))
            rows[(name, lane)] = (min(k1, k2), min(p1, p2))
            log(f"  4K {lane} {name}: kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms [{smi}]")

        nb = 270 * 480

        def step():
            state = limg_tpu_torch.fused_merged_pre(img_d, cfg, 0, lv, need_q=False,
                                                    device=device)
            cap = limg_tpu_torch.auto_run_capacity(int(state["n_run_blocks"]), nb)
            out = limg_tpu_torch.fused_merged_finish(state, cfg, 0, lv, False, cap)
            return out["total_err"], out["mean_bpp"]

        step_ms = time_fn(step, device)
        log(f"  4K {lane} default merged step (fused_merged_pre, host capacity read, "
            f"fused_merged_finish; emit_planes=False): {step_ms!r} ms = "
            f"{mpx / step_ms * 1e3!r} Mpx/s [{smi}]")
        profile_step(step, device, f"{lane} default merged")
    log(f"phase 4c ok: 4K run-coalescing kernel outputs equal the plain versions' "
        f"(max abs diff {worst})")
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
    log(f"  profile 4K {lane} step: device busy {busy!r} us of {wall_us!r} us wall "
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
    worst_m = phase_compare_merged(device)
    worst_c = phase_compare_coalesce(device)
    launched = phase_main_path(device)
    launched_m = phase_main_path_merged(device)
    launched_c = phase_main_path_coalesce(device)
    rows, worst4k = phase_timing(device, smi)
    rows_m, worst4k_m = phase_timing_merged(device, smi)
    rows_c, worst4k_c = phase_timing_coalesce(device, smi)
    k_ms, p_ms = rows["rgb"]     # the 4K RGB lane; RGBA is printed above
    kernels = [{
        "name": "encode_fixed_p64", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launched, "max_abs_err": max(worst, worst4k),
        "ms": k_ms, "plain_ms": p_ms,
    }]
    for name, replaces in MERGED_REPLACES.items():
        k_ms, p_ms = rows_m[(name, "rgb")]
        kernels.append({
            "name": name, "route": "cuda", "source": MERGED_SOURCE, "replaces": replaces,
            "launches": launched_m[name], "max_abs_err": max(worst_m, worst4k_m),
            "ms": k_ms, "plain_ms": p_ms,
        })
    for name, replaces in COALESCE_REPLACES.items():
        k_ms, p_ms = rows_c[(name, "rgb")]
        kernels.append({
            "name": name, "route": "cuda", "source": COALESCE_SOURCE, "replaces": replaces,
            "launches": launched_c[name], "max_abs_err": max(worst_c, worst4k_c),
            "ms": k_ms, "plain_ms": p_ms,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
