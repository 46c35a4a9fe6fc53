"""Time the kernels of limg_tpu_torch alone at 4K on one CUDA card, beside
a baseline checkout of the same package.

    python3 tools/profile_torch_kernels.py [--baseline DIR] [--out FILE] [--lane rgb]
                                           [--kernels-only] [--kernels REGEX]

Builds ``encode_fixed``, ``encode_region``, ``encode_merged``,
``encode_natural``, ``coalesce``, ``segment_region`` and ``crush_eval``
from this checkout (and, with
``--baseline``, the same libraries of the checkout at DIR into DIR's own
``build/kernels``, by DIR's own package) and prints what ``ptxas -v``
reports for every kernel: registers, spill bytes, stack frame. Then, on the
4K RGB and RGBA test images (tools/make_test_image.make_4k, error_factor
100, ladder K = 8):

- each kernel of this checkout against its plain version on the same
  inputs (bit-equal, as chip_smoke.py holds them);
- each kernel's time alone, CUDA events (median of 10 single calls after a
  warm-up, and the mean of 10 calls back to back, which hides the host's
  launch overhead) and torch.profiler device time of the kernel itself
  (mean over 5 calls; beside it the device busy time of the whole call,
  whose difference is the wrapper's copies and glue) side by side:
  ``encode_fixed_p64`` on the fixed grid's 129,600 blocks and
  ``encode_region`` on the RD levels' 32,400 / 8,160 / 2,040 regions of
  256 / 1,024 / 4,096 pixels and the dense levels' 510 / 135 / 40 of
  16,384 / 65,536 / 262,144, each also with ``crush_mode="none"`` (which
  prices the search against the fit); ``fit_levels`` at 3 levels and at 2
  (the price of a level), ``fit_levels_natural``, ``owner_crush`` (ladder
  K = 8, and with ``crush_mode="none"``, which prices the search),
  ``owner_crush_natural``, ``match_neighbors`` on the default encode's
  level-0 and level-1 row planes, (7ch, 270, 480) and (7ch, 135, 240),
  ``match_pairs`` on level 2's 16,132 neighbour pairs, (7ch, 16,132),
  ``seg_mixed_all`` on one row of ones at 129,600 / 32,400 / 8,160 lanes
  (the run lengths of levels 0-2), the segment scans of one default and
  one RD step (every scan launch of the step, summed: ``seg_scan ...
  step``), an empty kernel (the device time of a launch that does
  nothing), and ``segment_encode`` on the default encode's run buffer,
  whole and cut to its member lanes (the price of the lanes that hold no
  run member); ``crush_eval_rows`` at the two calls of the composed
  coalesce pass on the 4K default state (``coalesce_segments(use_kernel=
  False)``): the ladder's 27 axis sweeps, a stride-0 table over the
  129,600-lane run buffer (``crush_eval_rows sweep K=27``), and its 8
  verified candidates, one triple a block (``crush_eval_rows verify K=8``),
  with the device time of a contiguous copy of the sweep table
  (``crush_eval_rows sweep cands copy``), and the composed pass as a whole
  (``composed coalesce pass``: the pass's device busy, and the
  ``crush_eval`` kernels' time in it; held bit-equal to the segment
  kernel's pass); ``segment_encode`` on the dense path's own buffers
  (``segment_encode P=... dense``: P = 256 / 1024 / 4096 captured from a
  4-level ``encode_image_merged(fused=False)``, P = 16,384 / 65,536 from a
  6-level one; its bound, chip_smoke.py ``kernel_bound``, beside it); with
  a baseline, the two builds in turns (baseline, this, this, baseline);
- the run buffer's segment lengths (how many segments and 128-lane tiles
  hold more than 32 members), and how many blocks own at each level (the
  fit's ``owner``) and how many 3-level squares hold an owner of level 2;
- the fixed-grid step (``encode_perf_step``), the default merged step, the
  natural default step (``fused_merged_pre``, the capacity read,
  ``fused_merged_finish``) and the RD step (``fused_rd_pre``, the capacity
  read, ``fused_rd_finish``) and the dense 3- and 5-level steps
  (``encode_image_merged_device``, full run capacity, as chip_smoke.py
  phases 4f / 4h) by events and by the profiler's device busy time, with
  each build;
- the 4K encodes of the fixed grid and of every merged path (Morton with
  and without coalescing, natural, RD at 3 and 4 levels, the dense path at
  4, 5 and 6 levels) with dithering off, with each build: PSNR, bpp, the
  decoded image's sum, and for the merged paths the runs and the blocks
  whose owner level differs from the JAX package's recorded default encode
  (tests/fixtures/torch_port_coalesce_reference.npz).

The baseline runs as its own package (its wrappers, glue and kernels,
imported under another module name), on inputs made by this checkout, so
a change of a kernel's C interface or of its callers is compared as a
whole; with a baseline, the SASS (``cuobjdump -sass``) of each build's
segment encode (every P) and of the fixed grid and region encode up to P
= 4096, compared instruction by instruction (SASS_KERNELS). Writes the numbers as JSON to FILE (default
build/profile_kernels.json). Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LIBRARIES = ("encode_fixed", "encode_region", "encode_merged", "encode_natural", "coalesce",
             "segment_region", "crush_eval")
COALESCE_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_coalesce_reference.npz"
RUNS = 10
PROFILED = 5
RD_LAMBDA = 0.01
# a launch that does nothing: the device time every launch pays
EMPTY_SOURCE = """
__global__ void empty_kernel() {}
extern "C" int limg_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def log(*args):
    print(*args, flush=True)


def kernel_name(line: str) -> str | None:
    """name<template arguments> of the kernel whose mangled symbol a ptxas
    "Compiling entry function" line names (each identifier is its length,
    then the name)."""
    m = re.search(r"Compiling entry function '(\w+)'", line)
    if not m:
        return None
    sym = m.group(1)
    for n in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel))", sym):
        size, ident = int(n.group(1)), n.group(2)
        if len(ident) == size:
            rest = sym[n.start(2) + size:]
            t = re.match(r"I((?:L[ib]\d+E|[if])+)E", rest)
            targs = re.findall(r"L[ib](\d+)E|([if])", t.group(1)) if t else []
            args = ",".join(v or {"i": "int", "f": "float"}[c] for v, c in targs)
            return f"{ident}<{args}>"
    return None


def ptxas_lines(text: str) -> list[str]:
    """ptxas -v's report, one line per kernel: name<template arguments>,
    registers, stack frame, spill stores / loads."""
    out, name = [], None
    for ln in text.splitlines():
        kernel = kernel_name(ln)
        if kernel:
            name, frame, spill = kernel, "", ""
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


def load_checkout(checkout: Path | None, alias: str) -> SimpleNamespace:
    """The limg_tpu_torch package of ``checkout`` (None: this one), imported
    as ``alias``, with its kernels built: its modules, and ptxas's report
    of each library."""
    if checkout is None:
        pkg = importlib.import_module("limg_tpu_torch")
    else:
        pkg_dir = checkout / "limg_tpu_torch"
        spec = importlib.util.spec_from_file_location(alias, pkg_dir / "__init__.py",
                                                      submodule_search_locations=[str(pkg_dir)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[alias] = pkg
        spec.loader.exec_module(pkg)
    name = pkg.__name__
    mods = {short: importlib.import_module(f"{name}.{path}") for short, path in (
        ("build", "kernels.build"), ("kc", "kernels.coalesce"), ("kf", "kernels.encode_fixed"),
        ("km", "kernels.encode_merged"), ("kn", "kernels.encode_natural"),
        ("kce", "kernels.crush_eval"),
        ("encoder", "encoder"), ("regions", "regions"))}
    # a checkout from before a library existed builds the others
    libs = [n for n in LIBRARIES if (mods["build"].CSRC / f"{n}.cu").exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(mods["build"].load_library, libs))
    log(f"built {', '.join(libs)} of {checkout or ROOT} in {time.perf_counter() - t0:.1f} s")
    ptxas = {n: ptxas_lines(mods["build"].build_log.get(n, "")) for n in libs}
    return SimpleNamespace(pkg=pkg, ptxas=ptxas, **mods)


def empty_launcher(build):
    """A callable that launches the empty kernel on the current stream."""
    import torch

    out = build.BUILD_DIR / "libempty_kernel.so"
    src = out.with_suffix(".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_SOURCE)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.limg_empty.argtypes = [ctypes.c_void_p]
    lib.limg_empty.restype = ctypes.c_int

    def launch():
        rc = lib.limg_empty(torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed ({rc})")
    return launch


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
    from limg_tpu_torch.utils.timing import profile_device

    prof = profile_device(fn, PROFILED, device=device, windows=1)
    kern = sum(us for key, us in prof.kernels.items() if pattern and re.search(pattern, key))
    return kern / 1e3, prof.busy_us / 1e3


def sass_functions(build, library: str, pattern: str) -> dict:
    """{mangled name: its SASS instructions, addresses and encodings dropped}
    of the functions of a built library whose name matches ``pattern``."""
    so = build.BUILD_DIR / f"lib{library}_{build.source_digest(library)}.so"
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out[name] = []
            continue
        ins = re.sub(r"/\*.*?\*/", "", ln).strip()
        if name and ins and not ins.startswith("."):
            out[name].append(ins)
    return out


# (library, kernel symbol pattern) whose SASS the two builds compare: the
# segment encode at P = 64, 256 and from 1024 on (its cluster and first-pass
# kernels), the fixed grid and the region encode up to P = 4096
SASS_KERNELS = (
    ("coalesce", r"segment_encode_kernelILi[34]ELi0E"),
    ("segment_region", r"segment_(encode|cluster|prep)_kernelILi[34]ELi\d+E"),
    ("encode_fixed", r"encode_region_kernelILi64ELi[34]E"),
    ("encode_region", r"encode_region_kernelILi(256|1024|4096)ELi[34]E"),
)


def compare_sass(builds) -> dict:
    """The SASS_KERNELS of each build: instructions, and the lines that
    differ between the two."""
    out = {}
    for library, pattern in SASS_KERNELS:
        # the anonymous namespace's mangled name carries a hash of the
        # source's path
        sass = {w: {re.search(pattern + r".*", fn).group(0): ins
                    for fn, ins in sass_functions(b.build, library, pattern).items()}
                for w, b in builds.items()}
        for fn, ins in sass["this"].items():
            base = sass.get("baseline", {}).get(fn)
            diff = None if base is None else (sum(a != b for a, b in zip(ins, base))
                                              + abs(len(ins) - len(base)))
            out[fn] = {"this": len(ins), "baseline": None if base is None else len(base),
                       "differing_lines": diff}
            log(f"  SASS {library} {fn}: {len(ins)} instructions, baseline "
                f"{'-' if base is None else len(base)}, differing lines {diff}")
    return out


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
    from chip_smoke import (capture_coalesce_calls, compare_outputs, image_run_buffer,
                            kernel_bound, run_text, seg_map)
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor, _packed_blocks
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.ops.dither import coalesce_key
    from limg_tpu_torch.regions import _words
    from tools.record_torch_reference import case_images

    device = torch.device("cuda", 0)
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log("card:", torch.cuda.get_device_name(0), "|", smi, "| torch", torch.__version__)
    builds = {"this": load_checkout(None, "limg_tpu_torch")}
    if args.baseline:
        builds["baseline"] = load_checkout(args.baseline.resolve(), "baseline_limg_tpu_torch")
    turns = ("baseline", "this", "this", "baseline") if args.baseline else ("this", "this")
    this = builds["this"]
    empty = empty_launcher(this.build)
    for which, b in builds.items():
        for name, lines in b.ptxas.items():
            for ln in lines:
                if re.search(r"encode_|fit_levels|owner_crush|match_|seg_scan|crush_eval|segment_",
                             ln):
                    log(f"  ptxas {which} {name}: {ln}")
    result = {"card": smi, "ptxas": {w: b.ptxas for w, b in builds.items()}, "kernels": {},
              "steps": {}, "encodes": {}, "segments": {}, "owners": {}, "bounds": {}}
    if args.baseline:
        result["sass"] = compare_sass(builds)
    fx = np.load(COALESCE_FIXTURE)
    images = case_images(2160, 3840)
    nb = 270 * 480
    for lane, img in images.items():
        if args.lane and lane not in args.lane:
            continue
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        ch = cfg.channels
        img_d = _as_image_tensor(img, device)
        words = _words(img_d)
        km, kc, kf = this.km, this.kc, this.kf
        fit = km.fit_levels_kernel(words, cfg, 3)
        fit_n = this.kn.fit_levels_natural_kernel(words, cfg, 3)
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
        # level 2's neighbour pairs, as neighbor_pair_matches pairs them
        p2 = plane[:, ::4, ::4]
        pairs = (torch.cat([p2[:, :, 1:].reshape(7 * ch, -1), p2[:, 1:].reshape(7 * ch, -1)], 1),
                 torch.cat([p2[:, :, :-1].reshape(7 * ch, -1), p2[:, :-1].reshape(7 * ch, -1)], 1))
        # one row of ones over run-like segments at each level's lane count
        rng = np.random.default_rng(16)
        scans = {n: (torch.ones((1, n), dtype=torch.int32, device=device),
                     torch.from_numpy(seg_map(rng, n, 16)).to(device))
                 for n in (nb, nb // 4, 68 * 120)}
        members = int(mask.any(dim=0).sum())
        cut = tuple(t[..., :members].contiguous() for t in (packed, mask, seg, blocks))
        result["segments"][lane] = {**segment_lengths(seg), "lanes": int(seg.numel()),
                                    "member_lanes": members}
        log(f"  4K {lane} run buffer: {result['segments'][lane]}")

        def step(P, layout="morton"):
            state = P.pkg.fused_merged_pre(img_d, cfg, 0, 3, need_q=False, device=device,
                                           fused_layout=layout)
            cap = P.pkg.auto_run_capacity(int(state["n_run_blocks"]), nb)
            out = P.pkg.fused_merged_finish(state, cfg, 0, 3, False, cap, fused_layout=layout)
            return out["total_err"], out["mean_bpp"]

        def dense_step(P, levels):
            # as chip_smoke.py phases 4f / 4h time it
            out = P.pkg.encode_image_merged_device(img_d, cfg, num_levels=levels,
                                                   emit_planes=False, cap_frac=1, device=device)
            return out["total_err"], out["mean_bpp"]

        def rd_step(P):
            state = P.pkg.fused_rd_pre(img_d, cfg, 0, RD_LAMBDA, 3, need_q=False, device=device)
            cap = P.pkg.auto_run_capacity(int(state["n_run_blocks"]), nb)
            out = P.pkg.fused_rd_finish(state, cfg, 0, RD_LAMBDA, 3, False, cap)
            return out["total_err"], out["mean_bpp"]

        # the composed coalesce pass on the default state at auto capacity,
        # and its crush_eval_rows calls, caught on this build's wrapper
        state = this.pkg.fused_merged_pre(img_d, cfg, 0, 3, device=device)
        cap = this.pkg.auto_run_capacity(int(state["n_run_blocks"]), nb)

        def composed(P, use_kernel=False):
            lv = {k: None if v is None else v.clone() for k, v in state["lv0"].items()}
            applied, n_runs, _ = P.regions.coalesce_segments(
                state["px"], state["mask"], state["seg0"], state["is_run0"], lv, cfg,
                coalesce_key(0, cfg.dither_seed), cap, need_planes=lv["q"] is not None,
                use_kernel=use_kernel)
            return [*lv.values(), applied, n_runs]

        ce_calls, ce_saved = [], this.kce.crush_eval_rows_kernel

        def ce_spy(*a):
            ce_calls.append(a)
            return ce_saved(*a)

        this.kce.crush_eval_rows_kernel = ce_spy
        try:
            composed(this)
        finally:
            this.kce.crush_eval_rows_kernel = ce_saved
        sweep, verify = ce_calls[:2]
        log(f"  4K {lane} composed pass: {len(ce_calls)} crush_eval_rows calls, K = "
            f"{[a[4].shape[0] for a in ce_calls]}, N = {sweep[0].shape[1]}, sweep cands "
            f"strides {sweep[4].stride()}")

        # the fixed grid's blocks, the RD levels' regions, as the RD step
        # encodes them (endpoints emitted), and the dense path's levels 4-6
        regions = {64: _packed_blocks(img_d)[:2]}
        for side in (16, 32, 64, 128, 256, 512):
            regions[side * side] = layout.blockify_words(words, side)[:2]
        # name: (call of a build, kernel name pattern, plain version or None)
        calls = {}
        for p, (rp, rm) in regions.items():
            name = "encode_fixed_p64" if p == 64 else f"encode_region_p{p}"
            for tag, c in (("", cfg), (" crush none", cfg_none)):
                calls[name + tag] = (
                    lambda P, rp=rp, rm=rm, c=c: P.kf.encode_blocks_kernel(rp, rm, c, 0, True),
                    # the parent's one-CTA kernel above P = 4096, this build's cluster
                    r"encode_(fixed_p64|region|region_chunked|region_cluster)_kernel",
                    lambda rp=rp, rm=rm, c=c: kf.encode_blocks_reference(rp, rm, c, 0, True))
        calls.update({
            "fit_levels L3": (lambda P: P.km.fit_levels_kernel(words, cfg, 3),
                              r"fit_levels_kernel", lambda: km.fit_levels_reference(words, cfg, 3)),
            "fit_levels L2": (lambda P: P.km.fit_levels_kernel(words, cfg, 2),
                              r"fit_levels_kernel", lambda: km.fit_levels_reference(words, cfg, 2)),
            "fit_levels_natural L3": (
                lambda P: P.kn.fit_levels_natural_kernel(words, cfg, 3), r"fit_levels_kernel",
                lambda: this.kn.fit_levels_natural_reference(words, cfg, 3)),
            "owner_crush L3": (lambda P: P.km.owner_crush_kernel(*crush_args),
                               r"owner_crush_kernel",
                               lambda: km.owner_crush_reference(*crush_args)),
            "owner_crush L3 crush none": (lambda P: P.km.owner_crush_kernel(*none_args),
                                          r"owner_crush_kernel",
                                          lambda: km.owner_crush_reference(*none_args)),
            "owner_crush_natural L3": (
                lambda P: P.kn.owner_crush_natural_kernel(*crush_n_args), r"owner_crush_kernel",
                lambda: this.kn.owner_crush_natural_reference(*crush_n_args)),
            "match_neighbors level 0": (
                lambda P: P.kc.match_neighbors_kernel(planes[0], ch), r"match_neighbors_kernel",
                lambda: kc.match_neighbors_reference(planes[0], ch)),
            "match_neighbors level 1": (
                lambda P: P.kc.match_neighbors_kernel(planes[1], ch), r"match_neighbors_kernel",
                lambda: kc.match_neighbors_reference(planes[1], ch)),
            "match_pairs level 2": (lambda P: P.kc.match_pairs_kernel(*pairs, ch),
                                    r"match_pairs_kernel",
                                    lambda: kc.match_pairs_reference(*pairs, ch)),
            **{f"seg_mixed_all {n} lanes": (
                lambda P, x=x, s=s: P.kc.seg_mixed_all_kernel(x, s, 1), r"seg_scan",
                lambda x=x, s=s: kc.seg_mixed_all_reference(x, s, 1))
               for n, (x, s) in scans.items()},
            "seg_scan default step": (step, r"seg_scan", None),
            "seg_scan RD step": (rd_step, r"seg_scan", None),
            "empty kernel": (lambda P: empty(), r"empty_kernel", None),
            "crush_eval_rows sweep K=27": (
                lambda P: P.kce.crush_eval_rows_kernel(*sweep), r"crush_eval",
                lambda: this.kce.crush_eval_rows_reference(*sweep)),
            "crush_eval_rows verify K=8": (
                lambda P: P.kce.crush_eval_rows_kernel(*verify), r"crush_eval",
                lambda: this.kce.crush_eval_rows_reference(*verify)),
            "crush_eval_rows sweep cands copy": (lambda P: sweep[4].contiguous(), r".", None),
            "composed coalesce pass": (composed, r"crush_eval", lambda: composed(this, True)),
            "segment_encode all lanes": (
                lambda P: P.kc.segment_encode_kernel(packed, mask, seg, blocks, cfg, 0x5EED),
                r"segment_encode_kernel",
                lambda: kc.segment_encode_reference(packed, mask, seg, blocks, cfg, 0x5EED)),
            "segment_encode member lanes": (
                lambda P: P.kc.segment_encode_kernel(*cut, cfg, 0x5EED), r"segment_encode_kernel",
                lambda: kc.segment_encode_reference(*cut, cfg, 0x5EED)),
        })
        # the segment encode on the dense path's level buffers at P > 64
        for levels, sizes in ((4, (256, 1024, 4096)), (6, (16384, 65536))):
            captured = capture_coalesce_calls(lambda: this.pkg.encode_image_merged(
                img_d, cfg, num_levels=levels, fused=False, fetch_planes=False, device=device))
            for a, kw in captured["segment_encode_kernel"]:
                p = a[0].shape[0]
                name = f"segment_encode P={p} dense"
                if p not in sizes or name in calls:
                    continue
                calls[name] = (lambda P, a=a, kw=kw: P.kc.segment_encode_kernel(*a, **kw),
                               r"segment_(encode|cluster|prep)_kernel",
                               lambda a=a, kw=kw: kc.segment_encode_reference(*a, **kw))
                got = kc.segment_encode_kernel(*a, **kw)
                members = int(a[1].any(dim=0).sum())
                bound = kernel_bound("segment_encode", a, got)
                result["bounds"][f"{lane} {name}"] = {"lanes": int(a[0].shape[1]),
                                                      "member_lanes": members,
                                                      "bound_ms": bound[0], "bound_by": bound[1]}
                log(f"  4K {lane} {name}: {a[0].shape[1]} lanes, {members} with a member pixel, "
                    f"bound {bound[0]!r} ms ({bound[1]})")

        def tensors(out):
            if isinstance(out, torch.Tensor):
                return [out]
            return [v if v is None or isinstance(v, torch.Tensor) else torch.as_tensor(v)
                    for v in out]

        chosen = [name for name in calls if re.search(args.kernels, name)]
        for name in chosen:
            fn, _, plain = calls[name]
            outs = {which: fn(b) for which, b in builds.items()}
            torch.cuda.synchronize(device)
            if plain is not None:
                compare_outputs(tensors(outs["this"]), tensors(plain()))
            if "baseline" in outs and outs["this"] is not None:
                compare_outputs(tensors(outs["this"]), tensors(outs["baseline"]))
        log(f"  4K {lane}: {len(chosen)} kernel calls bit-equal to their plain versions "
            f"and to the baseline's")
        for name in chosen:
            fn, pattern, _ = calls[name]
            rows = []
            for which in turns:
                b = builds[which]
                ev, batch = events_ms(lambda: fn(b), device)
                kern, busy = profiled(lambda: fn(b), device, pattern)
                rows.append({"build": which, "events_ms": ev, "batch_ms": batch,
                             "profiler_ms": kern, "call_busy_ms": busy})
            result["kernels"][f"{lane} {name}"] = rows
            log(f"  4K {lane} {name}: " + ", ".join(
                f"{r['build']} {r['events_ms']!r} ms (back to back {r['batch_ms']!r}, profiler "
                f"{r['profiler_ms']!r}, call busy {r['call_busy_ms']!r})" for r in rows)
                + f" [{smi}]")

        if args.kernels_only:
            continue
        steps = {"fixed-grid step": lambda P: P.encoder.encode_perf_step(img_d, cfg, 0, device),
                 "default merged step": step,
                 "natural default step": lambda P: step(P, "natural"),
                 "RD step": rd_step,
                 "dense 3-level step": lambda P: dense_step(P, 3),
                 "dense 5-level step": lambda P: dense_step(P, 5)}
        for name, fn in steps.items():
            rows = []
            for which in turns:
                b = builds[which]
                ev, _ = events_ms(lambda: fn(b), device)
                _, busy = profiled(lambda: fn(b), device, None)
                rows.append({"build": which, "events_ms": ev, "device_busy_ms": busy})
            result["steps"][f"{lane} {name}"] = rows
            log(f"  4K {lane} {name}: " + ", ".join(
                f"{r['build']} {r['events_ms']!r} ms (device busy {r['device_busy_ms']!r})"
                for r in rows) + f" [{smi}]")

        ref_owner = fx[f"4k_{lane}_l3.owner"]
        cfg0 = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False)
        rows = []
        for which in dict.fromkeys(turns):
            out = builds[which].pkg.encode_image(img, cfg0, device=device)
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
            "dense 4 levels": dict(fused=False, num_levels=4),
            "dense 5 levels": dict(fused=False, num_levels=5),
            "dense 6 levels": dict(fused=False, num_levels=6),
        }
        for path, kw in paths.items():
            rows = []
            for which in dict.fromkeys(turns):
                kw = {"num_levels": 3, **kw}
                out = builds[which].pkg.encode_image_merged(img, cfg0, device=device, **kw)
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
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
