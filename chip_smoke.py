"""On-card smoke run of limg_tpu_torch: build the CUDA kernels, then drive
the public paths at 4K against the JAX package's recorded encodes: the
fixed-grid encode (``limg_tpu_torch.encode_image``), the quadtree-merged
encode without coalescing (``encode_image_merged(..., coalesce=False)``),
the default merged encode with run coalescing (``encode_image_merged()``,
and the CLI's merged mode), the RD merge policy
(``encode_image_merged(merge_policy="rd")``, and the CLI's
``--rd-merge``), the natural-layout default encode
(``encode_image_merged(fused_layout="natural", return_state=True)``) and
the composed coalesce pass (``coalesce_segments(use_kernel=False)``), the
dense path (``encode_image_merged(fused=False)``, 1, 3 and 4 levels, and
``encode_image_merged(num_levels=5 | 6)``, which only it runs); write,
read and diagnose LTP1 streams of the default encode (``bitstream``,
``utils.diagnostics``, the CLI's ``--write-ltp1`` / ``--decode-ltp1`` /
``--diagnose``, and ``--fixed-grid --write-ltp1``), run the legacy encoder
(``encode_legacy``), the scatter-form segment refit and crush
(``ops.segments.fit_segments`` / ``find_shifts_segments`` with
``contiguous=False``) on 4K segment maps, and encode corpora of 1080p
images over a one-card mesh (``limg_tpu_torch.parallel``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports neither JAX nor PIL. Through phases
3-3j every kernel wrapper, wherever the port imported it, is held to its
plain version on the paths' own 4K calls (``HeldKernels``: the first call
of each kernel and settings in a phase, the outputs equal, floats within
``DIST_RTOL``), and a kernel those phases launch but never hold fails the
run. The edge cases of each kernel against its plain version are
tests/test_torch_kernel_cuda.py and tests/test_torch_fixed_planes_cuda.py
(``-m cuda``), which take their case builders from this file; kernel
times come from the benchmark's cells (h100_bench/) and
tools/profile_torch_kernels.py. Phases:

0. environment: torch, CUDA, nvcc, Triton, the card's name and power limit;
1. build the kernel libraries from limg_tpu_torch/csrc/, one nvcc per
   source, all started together;
3. the fixed-grid path: ``encode_image`` on the 4K RGB and RGBA images,
   its kernel's and its epilogue's (``fixed_planes``, one an encode)
   launches counted from 0, stats held against the JAX
   package's recorded encode (tests/fixtures/torch_port_reference.json);
3b. the merged path without coalescing: ``encode_image_merged(coalesce=
   False)`` on the same images, both kernels' launches counted from 0, held
   against the JAX fused path's recorded encode (tests/fixtures/
   torch_port_merged_reference.npz);
3c. the default merged path: ``encode_image_merged()`` on the same images,
   the launches of all six merged-path kernels counted from 0, held against
   the JAX default encode (tests/fixtures/torch_port_coalesce_reference.npz),
   then the CLI's merged mode once;
3d. the RD path: ``encode_image_merged(merge_policy="rd")`` on the same
   images at 3 levels, the launches of its eight kernels counted from 0
   (one 4-level encode runs P = 4096), held against the JAX RD encode
   (tests/fixtures/torch_port_rd_reference.npz), then ``--rd-merge`` once;
3e. the natural path: ``encode_image_merged(fused_layout="natural",
   return_state=True)`` on the same images, its two kernels' launches
   counted from 0 (the Morton pair's must stay 0), held as in 3c against
   the JAX default encode and against the JAX natural-layout encode
   (tests/fixtures/torch_port_natural_reference.npz), and against the
   port's Morton encode, dithering off and on, equal bit for bit (planes,
   stats, runs, serializer state: both layouts sum a block in one order);
   then the composed coalesce pass
   on the 4K default state, ``crush_eval_rows`` counted from 0, bit-equal to
   the segment kernel's pass;
3f. the LTP1 stream and the diagnostics: the default
   ``encode_image_merged(return_state=True)`` on the 4K RGB and RGBA images
   (dithering on), its six kernels' launches counted from 0; its stream
   from ``bitstream.serialize_from_state`` on the native host runtime
   (g++-built ``limg_tpu_torch/runtime/limg_runtime.cpp``) and on the NumPy
   factor path, entropy on and off, equal bytes, ``deserialize`` giving the
   encode's image bit for bit; the host wall times of state fetch plus
   serialize, deserialize and ``crush_culprits_merged``, with the stream's
   real bpp beside the encode's estimate; the SHA-256 and length JAX
   recorded for the fixture states
   (tests/fixtures/torch_port_ltp1_reference.json), from JAX's state and
   from the port's encode of each case on the card; an RD stream that
   round-trips; the CLI's ``--write-ltp1`` + ``--diagnose`` and
   ``--decode-ltp1`` at 4K and ``--fixed-grid --diagnose`` on a small
   image, their culprit counts equal to the same functions' on the CPU;
3g. the dense path: ``encode_image_merged(fused=False)`` on the 4K RGB and
   RGBA images at 1 and 3 levels (match) against the JAX dense encode
   (tests/fixtures/torch_port_dense_reference.npz: stats, owners, run
   flags; where the state is JAX's, its stream's SHA-256), at 3 levels RD
   against the JAX dense RD encode (torch_port_rd_reference.npz), and one
   4-level encode, the launches of its eleven kernels counted from 0
   (``segment_encode`` at P = 64, 256, 1024 and 4096); the CLI's
   ``--fixed-grid --write-ltp1`` then ``--decode-ltp1``, giving the
   1-level encode's image bit for bit; ``encode_legacy`` at 4K, and on a
   small image equal to its CPU run;
3i. 5 and 6 levels: ``encode_image_merged(num_levels=5)`` on the 4K RGB and
   RGBA images and ``num_levels=6`` on the RGB one (the dense path), the
   launches of their fifteen kernels counted from 0 (the region and segment
   encodes at P = 16,384 and 65,536 among them), against the JAX dense
   encodes (tests/fixtures/torch_port_levels_reference.npz: owners and run
   flags on 99.9% of the blocks, stats within the dense tolerances); each
   stream written (JAX's SHA-256 where the state is JAX's) and refused by
   ``deserialize``, as the JAX package's reader refuses 5 levels;
3j. the scatter-form segment refit and crush on the 4K RGB and RGBA images'
   block grids, two segment maps each: the default 3-level encode's owner
   regions numbered in row-major block order (a square's members are not
   adjacent) and a seeded random map of 32,400 segments, some empty;
   ``fit_segments`` -> ``extract_factors`` / ``quantize_factors`` on
   ``gather_decomp`` -> ``find_shifts_segments`` under ladder, exhaustive
   and guess at num_factors 3 and 2, ``seg_sum_fold`` and
   ``crush_eval_rows`` counted from 0; every result equal to a second card
   run and to the CPU version (the fit on the whole map; the search on the
   map's first segments, up to 8,192 blocks for the ladder, 1,024 for the
   exhaustive search and the whole map for guess), empty segments (0, 0,
   0) and 2^31 - 1; ``seg_sum_fold`` against its plain version (the CPU's
   left fold; 6 cases, bit-equal) and ``index_add_`` on the card against
   it (the sums its atomics change);
3h. corpus and multi-device encode (``limg_tpu_torch.parallel``): the
   mesh (``make_mesh(1)`` is ``(cuda:0,)``, one past the card count
   raises); ``encode_corpus_sharded`` on 8 x 1080p (dithering off) in one
   ``encode_fixed_p64`` launch, each image's bpp equal to ``encode_image``'s
   and PSNR within 1e-4 dB, and again from the card-resident batch under
   ``torch.cuda.set_sync_debug_mode("error")`` up to its fetch; the same
   batch as 8 shard bodies on one card, equal; ``encode_image_blocks_sharded``
   on the 4K RGB image (dithering on, one shard) decoding to
   ``encode_image``'s bit for bit, also under the "error" mode;
   ``encode_corpus_sharded_merged`` (fused, 3 levels, dithering on) on the
   8 images, each bit-equal to its own ``encode_image_merged_fused_device``
   with ``image_seed(0, i)``, its host syncs counted under the "warn" mode;
   ``__graft_entry__.dryrun_multichip``'s three paths against
   MULTICHIP_EXPECTED.json at one card; ``encode_corpus_streaming`` on 32
   TGA files of 1080p on the native pool (each image equal to
   ``encode_image``'s; a missing file lands in ``failed``);
   ``encode_corpus_sharded_mixed`` on 5 x 1080p and 3 x 720p, some as TGA
   paths, equal to the direct encodes; every kernel's launches counted from
   0 over these calls.

Launches are counted by ``limg_tpu_torch.kernels.launch``. Prints a
``{"kernels": {name: {launches, held, max_abs_err, bound_ms, bound_by}}}``
line (the phases' launches, the calls held, the largest difference from
the plain version, the largest held call's bound), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_reference.json")
MERGED_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_merged_reference.npz")
COALESCE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_coalesce_reference.npz")
RD_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_rd_reference.npz")
NATURAL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_natural_reference.npz")
DENSE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_dense_reference.npz")
LEVELS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_levels_reference.npz")
LIBRARIES = ("encode_fixed", "encode_merged", "coalesce", "segment_region", "encode_region",
             "encode_natural", "crush_eval", "seg_fold", "fixed_planes")
# the kernels of the quadtree fit and crush (Morton and natural layouts) and
# of run building and coalescing, by their launch counts' names
MERGED_KERNELS = ("fit_levels", "owner_crush")
NATURAL_KERNELS = ("fit_levels_natural", "owner_crush_natural")
COALESCE_KERNELS = ("match_neighbors", "match_pairs", "seg_mixed_all", "segment_encode_p64")
# the fixed-grid epilogue's largest grid: the benchmark's 8192 x 5464 photos
FIXED_PLANES_SIZE = (5464, 8192)
RD_LAMBDA = 0.01
# the RD path's kernels
RD_KERNELS = ("encode_fixed_p64", "encode_region_p256", "encode_region_p1024",
              "encode_region_p4096", *COALESCE_KERNELS)
# the segment encode's region sizes on the dense path's levels 1-3, and the
# dense path's kernels (at 1-4 levels)
SEGMENT_SIZES = (256, 1024, 4096)
DENSE_KERNELS = RD_KERNELS + tuple(f"segment_encode_p{p}" for p in SEGMENT_SIZES)
# the dense path's levels 4 and 5 at 4K (128x128 and 256x256 px regions, P =
# 16,384 and 65,536): the region and segment encodes of a 6-level encode
LEVEL_SIZES = (16384, 65536)
LEVELS_KERNELS = DENSE_KERNELS + tuple(f"{k}_p{p}" for k in ("encode_region", "segment_encode")
                                       for p in LEVEL_SIZES)
# 4K encodes at 5 and 6 levels against the JAX fixture: per-block owners and
# run flags
LEVELS_AGREE = 0.999
MERGED_LEVELS = 3
DIST_RTOL = 1e-6
# main-path tolerances against the JAX fixture
NODITHER_PSNR_DB, NODITHER_BPP, HIST_L1_FRAC = 0.02, 0.01, 0.005
DITHER_PSNR_DB, DITHER_BPP = 0.3, 0.1   # MULTICHIP_EXPECTED.json
ALIVE_FRAC, OWNER_AGREE = 0.005, 0.995  # merged: per-level counts, per-block owners
RUNS_FRAC = 0.02                        # coalesced: n_runs
LEVELS4_PSNR_DB, LEVELS4_BPP = 0.3, 0.1   # RD: 4 levels against 3 on the same image
# the bound of a call (the least time the card could take for it): the
# larger of its bytes over the HBM rate and its operations over their
# rate, from NVIDIA's H100 SXM data sheet (3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores). Every kernel here does 32-bit integer and
# float scalar work outside the tensor cores, all of it counted at the
# float32 rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def log(*args):
    print(*args, flush=True)


def launch_counts(names) -> dict:
    """The launches of the kernels ``names`` since the last
    ``launch.reset_launches()``."""
    from limg_tpu_torch.kernels import launch

    return {k: launch.launches[k] for k in names}


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


# owner crush and match_neighbors at their edges: image sizes that are not
# multiples of 32 or 64 px, and row planes of 1, 2, odd and non-multiple-of-32
# blocks a side
RAGGED_SIZES = ((37, 200), (130, 70), (8, 8), (100, 260))
NEIGHBOR_EDGES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 33), (2, 31), (3, 97), (33, 2), (17, 45),
                  (31, 33))


def flat_corner(img: np.ndarray) -> np.ndarray:
    """``img`` with a flat bottom-right quarter: the squares cut by both
    image edges merge up to the top level, so regions owned at level 2 or
    3 hold blocks outside the grid."""
    out = img.copy()
    h, w = out.shape[:2]
    out[h // 2:, w // 2:] = (90, 140, 60, 200)[: out.shape[2]]
    return out


def compare_ragged_crush(device, fit_plain, kernel, plain, sizes=RAGGED_SIZES,
                         channels=(3, 4), compare=None) -> tuple:
    """An owner-crush kernel against its plain version at ragged squares
    (``flat_corner`` images of ``sizes``), levels 2-4, RGB and RGBA, q
    emitted and not, dithering off and on, each case held by ``compare``
    (default ``compare_outputs``); (max abs diff, cases)."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.regions import _words

    worst, n_cases = 0.0, 0
    for h, w in sizes:
        rgb = small_image(h, w)
        for ch in channels:
            words = _words(_as_image_tensor(flat_corner(rgb if ch == 3 else with_alpha(rgb)),
                                            device))
            for levels in (2, 3, 4):
                for emit_q in (True, False):
                    for dith in (False, True):
                        cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, dithering=dith)
                        fit = fit_plain(words, cfg, levels)
                        args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, levels, 7, emit_q)
                        got = kernel(*args)
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        try:
                            worst = max(worst, (compare or compare_outputs)(
                                got, plain(*args)) or 0.0)
                        except AssertionError as e:
                            raise AssertionError(f"ragged {h}x{w} ch={ch} levels={levels} "
                                                 f"emit_q={emit_q} dither={dith}: {e}")
                        n_cases += 1
    return worst, n_cases


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


def compare_bits(got, want) -> float:
    """``compare_outputs`` with float outputs equal bit for bit too."""
    worst = compare_outputs(got, want)
    for i, (g, w) in enumerate(zip(got, want)):
        if not g.equal(w):
            raise AssertionError(f"output {i}: {int((g != w).sum())} of {g.numel()} values differ")
    return worst


# the region encode at its edges: a last CTA that holds fewer regions than
# the others (32 blocks a CTA at P = 64, 8 regions at 256, 2 at 1024; 96 x
# 160 px is 240 blocks, 60 / 15 / 6 regions) and regions with no pixel
# inside the image (a grid one region row and column larger than the image)
EDGE_IMAGE = (96, 160)
EDGE_SETTINGS = [("ladder", 3, True), ("exhaustive", 1, False), ("guess", 2, True),
                 ("none", 3, False), ("ladder", 1, False)]


def region_edge_buffers(words, p: int) -> dict:
    """{name: (packed, mask)} of the (H, W) words at P = p: the image's own
    grid, and a grid one region row and column larger (all-masked regions)."""
    from limg_tpu_torch.ops import layout

    side = int(p ** 0.5)
    g = layout.grid_for(*words.shape, side)
    big = g._replace(blocks_y=g.blocks_y + 1, blocks_x=g.blocks_x + 1)
    return {"grid": layout.blockify_words(words, side)[:2],
            "all-masked row and column": layout.blockify_words(words, side, big)[:2]}


def seg_map(rng, n: int, max_span: int = 256) -> np.ndarray:
    """Contiguous segments, ids = first positions, spans 1..max_span."""
    seg = np.empty(n, np.int32)
    i = 0
    while i < n:
        span = int(rng.integers(1, min(max_span, n - i) + 1))
        seg[i:i + span] = i
        i += span
    return seg


def owner_segment_map(owner: np.ndarray) -> tuple:
    """Per-block owner levels (by, bx) -> (seg_id (NB,) int32, S): each owner
    region, the aligned 2^l x 2^l square of blocks that holds a block of
    level l, one segment, numbered in the row-major order of its first
    block. A square of 2 or more blocks a side spans rows, so its members
    are not adjacent in the row-major block order."""
    by, bx = owner.shape
    y, x = np.mgrid[0:by, 0:bx]
    lvl = owner.astype(np.int64)
    key = (lvl * by + (y >> lvl)) * bx + (x >> lvl)
    _, first, inv = np.unique(key.ravel(), return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.ravel()].astype(np.int32), len(first)


def run_labels(rng, seg: np.ndarray) -> np.ndarray:
    """A segment map's runs relabelled by distinct random non-negative ids
    (the scan only compares ids: any labels of the runs scan alike)."""
    labels = rng.permutation(8 * seg.size + 16)[:seg.size].astype(np.int32)
    return labels[seg]


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


def edge_run_buffers(rng, ch: int, device) -> dict:
    """Run buffers at segment_encode's edges: segments of 1, 31, 32, 33 and
    256 members, some crossing the kernel's 128-lane tiles, then a tail of
    lanes with no member (singletons and longer segments); the same map
    with no member pixel at all; and the members alone."""
    import torch

    spans = [1, 31, 32, 33, 256, 1, 33, 95, 256, 32, 31, 1]
    tail = [1, 7, 1, 1, 40, 3, 256, 1, 1, 20]
    n_mem, n = sum(spans), sum(spans) + sum(tail)
    seg = np.concatenate([np.full(k, start, np.int32) for k, start in
                          zip(spans + tail, np.cumsum([0] + spans + tail)[:-1])])
    words, mask, _, blocks = seeded_run_buffer(rng, n, ch, device)
    mask = mask.clone()
    mask[:, n_mem:] = False
    seg = torch.from_numpy(seg).to(device)
    cut = (words[:, :n_mem].contiguous(), mask[:, :n_mem].contiguous(), seg[:n_mem].contiguous(),
           blocks[:n_mem].contiguous())
    return {"edges+empty tail": (words, mask, seg, blocks),
            "no member": (words, torch.zeros_like(mask), seg, blocks),
            "edges": cut}


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
    lv0, grid = state["lv0"], state["grid"]
    rows = torch.cat([lv0["avg"], lv0["eps"].reshape(-1, nb).to(torch.float32)])
    return buf, rows.reshape(-1, grid.blocks_y, grid.blocks_x)


# seg_scan problem sizes: 1 lane, within a warp, around SEG_CAP, within one
# 2,048-lane tile, around a tile and two, and the three levels' lanes at 4K
SCAN_SIZES = (1, 7, 255, 256, 257, 5000, 2047, 2048, 2049, 4097, 8160, 32400, 129600)


def scan_batches(rng, device) -> dict:
    """Seeded seg_scan batches: {name: [ScanProblem, ...]}. Every problem
    ends inside a tile or on its edge; segments up to and over SEG_CAP
    (where a lane sees only part of its segment), ids that are first
    positions, other labels of the runs, or repeated and negative (-1 and
    -2 are the outside fills' ids); int rows with wrapping sums,
    ones rows and min / max, float rows of sums over many magnitudes;
    column problems of (gy, gx) maps."""
    import torch
    from limg_tpu_torch.kernels.coalesce import ScanProblem

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def ints(n, lo=-2**31, hi=2**31 - 1):
        return t(rng.integers(lo, hi, n).astype(np.int32))

    def floats(n):
        return t((rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32))

    batches = {}
    for dtype in ("int32", "float32"):
        probs = []
        for i, n in enumerate(SCAN_SIZES):
            seg = seg_map(rng, n, (256, 16, 400)[i % 3])
            if i % 4 == 1:
                seg = run_labels(rng, seg)
            elif i % 4 == 3:
                seg = rng.integers(-3, 3, n).astype(np.int32)
            if dtype == "int32":
                rows, ops = [None, ints(n), ints(n, -9, 9), ints(n, 0, 2)], ("ssxn", "nxs", "s")[i % 3]
                rows = rows[:len(ops)]
                init = (7, -2**31, 0)[i % 3]
            else:
                rows, ops = [floats(n), floats(n), floats(n)], ("sxn", "s", "ss")[i % 3]
                rows = rows[:len(ops)]
                init = (-3.4e38, 0.0, 1.5)[i % 3]
            probs.append(ScanProblem(t(seg), rows, ops, init))
        batches[dtype] = probs
    cols = []
    for gy, gx in ((1, 300), (300, 1), (37, 61), (135, 240), (270, 480)):
        seg = seg_map(rng, gy * gx, 20).reshape(gx, gy).T
        cols.append(ScanProblem(t(seg), [None, t(rng.integers(0, 2, (gy, gx)).astype(np.int32))],
                                "sn", 1, columns=True))
    batches["columns"] = cols
    # more problems than one launch takes
    batches["17 problems"] = [ScanProblem(t(seg_map(rng, n, 64)), [None], "s")
                              for n in rng.integers(1, 3000, 17)]
    return batches


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
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import launch
    from tools.record_torch_reference import case_images

    log("== phase 3: fixed-grid path (limg_tpu_torch.encode_image)")
    with open(FIXTURE) as f:
        cases = json.load(f)["cases"]
    h, w = cases[f"{size}_rgb_nodither"]["height"], cases[f"{size}_rgb_nodither"]["width"]
    images = case_images(h, w)
    launch.reset_launches()
    n_encodes = 0
    for lane, img in images.items():
        for dith in (False, True):
            name = f"{size}_{lane}_{'dither' if dith else 'nodither'}"
            cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
            before = launch.launches["encode_fixed_p64"]
            t0 = time.perf_counter()
            out = limg_tpu_torch.encode_image(img, cfg, seed=0, device=device)
            secs = time.perf_counter() - t0
            n_encodes += 1
            if device.type == "cuda" and launch.launches["encode_fixed_p64"] <= before:
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
    n_fixed, n_planes = launch.launches["encode_fixed_p64"], launch.launches["fixed_planes"]
    if n_fixed == 0:
        raise AssertionError("the fixed-grid path launched no encode_fixed_p64 kernel")
    if n_planes != n_encodes + 1:
        raise AssertionError(f"{n_planes} fixed_planes launches for {n_encodes + 1} encodes")
    log(f"phase 3 ok: {n_encodes + 1} encodes, {n_fixed} kernel launches and {n_planes} "
        f"of fixed_planes, outputs on {decoded.device}")


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
    from limg_tpu_torch.kernels import launch
    from tools.record_torch_reference import case_images

    log("== phase 3b: merged path (limg_tpu_torch.encode_image_merged, coalesce=False)")
    fx = np.load(MERGED_FIXTURE)
    h, w = 2160, 3840
    images = case_images(h, w)
    launch.reset_launches()
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
    launched = launch_counts(MERGED_KERNELS)
    if min(launched.values()) == 0:
        raise AssertionError(f"the merged path skipped a kernel: launches {launched}")
    log(f"phase 3b ok: {n_encodes + 1} encodes, launches {launched}, outputs on "
        f"{dev_out['decoded'].device}")


def dither_effect(name: str, rd: bool) -> tuple:
    """JAX's own (PSNR, bpp) change from dithering on the 4K lane ``name``.
    No JAX path dithers the fused coalesced encode on the CPU. Match
    policy: its dense dithered encode against its fused undithered one,
    coalescing off (tests/fixtures/torch_port_merged_reference.npz); bpp
    does not change. RD policy, whose cut weighs the dithered distortion:
    its dense RD encode with dithering on against off
    (tests/fixtures/torch_port_rd_reference.npz)."""
    if rd:
        fx = np.load(RD_FIXTURE)
        on, off = f"{name}_dither_dense", f"{name}_dense"
        return (float(fx[f"{on}.psnr"]) - float(fx[f"{off}.psnr"]),
                float(fx[f"{on}.mean_bpp"]) - float(fx[f"{off}.mean_bpp"]))
    mfx = np.load(MERGED_FIXTURE)
    return float(mfx[f"{name}_dither_dense.psnr"]) - float(mfx[f"{name}.psnr"]), 0.0


def check_coalesced_against_fixture(name: str, out: dict, fx, n_px: int, dithering: bool,
                                    rd: bool = False):
    """Stats of one 4K coalesced merged encode (match or ``rd`` policy)
    against the JAX encode's recorded ones; a dithered encode against the
    recorded ones plus JAX's own dither effect (``dither_effect``)."""
    ref_psnr, ref_bpp = float(fx[f"{name}.psnr"]), float(fx[f"{name}.mean_bpp"])
    if dithering:
        e_psnr, e_bpp = dither_effect(name, rd)
        ref_psnr, ref_bpp = ref_psnr + e_psnr, ref_bpp + e_bpp
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


def phase_main_path_coalesce(device):
    """encode_image_merged() with its defaults at 4K through all six
    merged-path kernels, then the CLI's merged mode."""
    import tempfile

    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import launch
    from tools.record_torch_reference import case_images

    log("== phase 3c: default merged path (limg_tpu_torch.encode_image_merged(), coalescing on)")
    fx = np.load(COALESCE_FIXTURE)
    h, w = 2160, 3840
    images = case_images(h, w)
    launch.reset_launches()
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
    launched = launch_counts(MERGED_KERNELS + COALESCE_KERNELS)
    if min(launched.values()) == 0:
        raise AssertionError(f"the default merged path skipped a kernel: launches {launched}")
    log(f"  {n_encodes} encodes, launches {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "img4k.npy")
        np.save(npy, images["rgb"])
        for ln in run_cli([npy, "--no-output"]):
            log(f"  cli: {ln}")
    log("phase 3c ok")


def run_cli(args) -> list:
    """The CLI's stats lines for ``args``, its stdout captured."""
    import contextlib
    import io

    from limg_tpu_torch import cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.main(args)
    lines = [ln for ln in text.getvalue().splitlines()
             if ln.startswith(("limg_tpu_torch", "Elapsed", "Compression", "Image Perceptual"))]
    if len(lines) != 4:
        raise AssertionError(f"the CLI ({args[1:]}) printed {text.getvalue()!r}")
    return lines


def phase_main_path_rd(device):
    """encode_image_merged(merge_policy="rd") at 4K through its eight
    kernels: 3 levels against the JAX RD fixture, one 4-level encode
    (P = 4096), then the CLI's --rd-merge."""
    import tempfile

    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import launch
    from tools.record_torch_reference import case_images

    log("== phase 3d: RD path (limg_tpu_torch.encode_image_merged(merge_policy='rd'))")
    fx = np.load(RD_FIXTURE)
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    launch.reset_launches()
    n_encodes, l3 = 0, {}
    for lane, img in images.items():
        for dith in (False, True):
            cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
            t0 = time.perf_counter()
            out = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=MERGED_LEVELS,
                                                     merge_policy="rd", rd_lambda=RD_LAMBDA,
                                                     device=device)
            secs = time.perf_counter() - t0
            n_encodes += 1
            dec = out["decoded"]
            if dec.shape != (h, w, 4) or not np.isfinite(out["psnr"]) or out["n_runs"] <= 0:
                raise AssertionError(f"{lane}: decoded {dec.shape}, psnr {out['psnr']}, "
                                     f"runs {out['n_runs']}")
            name = f"4k_{lane}_l{MERGED_LEVELS}"
            log(f"  4k_{lane} dither={dith}: RD encode_image_merged {secs * 1e3:.1f} ms wall "
                f"(host copies included)")
            check_coalesced_against_fixture(name, out, fx, h * w, dith, rd=True)
            if not dith:
                l3[lane] = out
                kept = np.asarray([s["kept"] for s in out["merge_stats"]])
                ref_kept = fx[f"{name}.merge_stats"][:, 0]
                log(f"    kept per level {kept.tolist()} (JAX {ref_kept.tolist()})")
                if (np.abs(kept - ref_kept) > ALIVE_FRAC * np.maximum(ref_kept, 1)).any():
                    raise AssertionError(f"{name}: kept regions outside {ALIVE_FRAC}")
    # one 4-level encode: level 3's 64x64 px regions (P = 4096)
    cfg = EncodeConfig(error_factor=100, dithering=False)
    out = limg_tpu_torch.encode_image_merged(images["rgb"], cfg, num_levels=4, merge_policy="rd",
                                             rd_lambda=RD_LAMBDA, device=device)
    n_encodes += 1
    ref = l3["rgb"]
    log(f"  4k_rgb levels=4: psnr {out['psnr']!r} bpp {out['mean_bpp']!r} alive "
        f"{out['alive_counts'].tolist()} runs {out['n_runs']} (3 levels: psnr {ref['psnr']!r} "
        f"bpp {ref['mean_bpp']!r})")
    # a fourth level adds 64x64 regions where they cost less: the encode
    # stays within a few hundredths of the 3-level one
    if (len(out["alive_counts"]) != 4 or out["coalesce_stats"]["dropped_runs_at_capacity"]
            or abs(out["psnr"] - ref["psnr"]) > LEVELS4_PSNR_DB
            or abs(out["mean_bpp"] - ref["mean_bpp"]) > LEVELS4_BPP):
        raise AssertionError("the 4-level RD encode is off the 3-level one")
    launched = launch_counts(RD_KERNELS)
    if min(launched.values()) == 0:
        raise AssertionError(f"the RD path skipped a kernel: launches {launched}")
    log(f"  {n_encodes} encodes, launches {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "img4k.npy")
        np.save(npy, images["rgb"])
        for ln in run_cli([npy, "--rd-merge", "--no-output"]):
            log(f"  cli --rd-merge: {ln}")
    log("phase 3d ok")


def composed_pass(state, cfg, seed: int, use_kernel: bool) -> tuple:
    """One coalesce pass over a ``fused_merged_pre`` state at auto capacity,
    through the segment kernel (``use_kernel``) or the composed re-encode:
    (the updated rows and planes, applied, n_runs, coalesce_stats)."""
    import limg_tpu_torch
    from limg_tpu_torch import regions
    from limg_tpu_torch.ops.dither import coalesce_key

    nb = state["grid"].num_blocks
    cap = limg_tpu_torch.auto_run_capacity(int(state["n_run_blocks"]), nb)
    lv = {k: None if v is None else v.clone() for k, v in state["lv0"].items()}
    applied, n_runs, stats = regions.coalesce_segments(
        state["px"], state["mask"], state["seg0"], state["is_run0"], lv, cfg,
        coalesce_key(seed, cfg.dither_seed), cap, need_planes=lv["q"] is not None,
        use_kernel=use_kernel)
    return lv, applied, n_runs, stats


def phase_main_path_natural(device):
    """encode_image_merged(fused_layout="natural", return_state=True) at 4K
    through the natural pair, against the JAX default encode and the port's
    Morton encode; then the composed coalesce pass on the 4K default state
    through crush_eval_rows."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import launch
    from tools.record_torch_reference import case_images

    log("== phase 3e: natural-layout default path (encode_image_merged(fused_layout='natural', "
        "return_state=True))")
    fx, nfx = np.load(COALESCE_FIXTURE), np.load(NATURAL_FIXTURE)
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    nb = -(-h // 8) * -(-w // 8)
    launch.reset_launches()
    outs = {}
    for lane, img in images.items():
        for dith in (False, True):
            cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
            t0 = time.perf_counter()
            out, state = limg_tpu_torch.encode_image_merged(
                img, cfg, num_levels=MERGED_LEVELS, return_state=True, fused_layout="natural",
                device=device)
            secs = time.perf_counter() - t0
            dec = out["decoded"]
            if (dec.shape != (h, w, 4) or not np.isfinite(out["psnr"]) or out["n_runs"] <= 0
                    or state["rows"].shape != (6 * cfg.channels + 6, nb)
                    or state["q"].shape != (3, 64, nb)):
                raise AssertionError(f"{lane}: decoded {dec.shape}, psnr {out['psnr']}, "
                                     f"runs {out['n_runs']}, state {state['rows'].shape}")
            log(f"  4k_{lane} dither={dith}: natural encode_image_merged {secs * 1e3:.1f} ms "
                f"wall (host copies and the state's fetch included)")
            name = f"4k_{lane}_l{MERGED_LEVELS}"
            log("    against the JAX default (Morton) encode:")
            check_coalesced_against_fixture(name, out, fx, h * w, dith)
            log("    against the JAX natural-layout encode:")
            check_coalesced_against_fixture(name, out, nfx, h * w, dith)
            outs[(lane, dith)] = (out, state)
    launched = launch_counts(NATURAL_KERNELS + MERGED_KERNELS + COALESCE_KERNELS)
    if min(launched[k] for k in NATURAL_KERNELS + COALESCE_KERNELS) == 0 or any(
            launched[k] for k in MERGED_KERNELS):
        raise AssertionError(f"the natural path's launches are off: {launched}")
    log(f"  {len(outs)} encodes, launches {launched}")
    # the port's Morton encode of the same inputs: both layouts sum a block
    # in one order, so the two encodes are equal bit for bit
    for (lane, dith), (out, state) in outs.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=dith)
        m_out, m_state = limg_tpu_torch.encode_image_merged(
            images[lane], cfg, num_levels=MERGED_LEVELS, return_state=True, device=device)
        differ = [k for k in ("decoded", "owner_px", "alive_counts", "bits_histogram", "factors",
                              "endpoint_rows") if not np.array_equal(out[k], m_out[k])]
        differ += [k for k in ("psnr", "mean_bpp", "n_runs", "coalesce_stats")
                   if out[k] != m_out[k]]
        differ += [f"state {k}" for k in ("rows", "q") if not np.array_equal(state[k], m_state[k])]
        log(f"  4k_{lane} dither={dith} natural vs Morton: "
            + (f"differ in {differ}" if differ else "equal (planes, stats, runs, state)"))
        if differ:
            raise AssertionError(f"4k_{lane} dither={dith}: the natural encode differs from the "
                                 f"Morton one in {differ}")
    # the composed coalesce pass (coalesce_segments(use_kernel=False)) on the
    # 4K default state, counted from 0, against the segment kernel's pass
    cfg = EncodeConfig(error_factor=100)
    state = limg_tpu_torch.fused_merged_pre(images["rgb"], cfg, 0, MERGED_LEVELS, device=device)
    want = composed_pass(state, cfg, 0, True)
    launch.reset_launches()
    got = composed_pass(state, cfg, 0, False)
    composed = launch_counts(("crush_eval_rows", "seg_mixed_all", "segment_encode_p64"))
    lv_k, lv_c = want[0], got[0]
    diff = [k for k in lv_k if not torch.equal(lv_k[k], lv_c[k])]
    if (diff or not torch.equal(want[1], got[1]) or int(want[2]) != int(got[2])
            or {k: int(v) for k, v in want[3].items()} != {k: int(v) for k, v in got[3].items()}):
        raise AssertionError(f"the composed coalesce pass differs from the segment kernel's: {diff}")
    if composed["crush_eval_rows"] == 0 or composed["segment_encode_p64"] != 0:
        raise AssertionError(f"the composed pass's launches are off: {composed}")
    log(f"  composed coalesce pass on the 4K RGB default state ({int(got[2])} runs): bit-equal to "
        f"the segment kernel's; launches {composed}")
    log("phase 3e ok")


# ---------------------------------------------------------------------------
# Phase 3f: the LTP1 stream and the diagnostics (host code on the encode's
# state; the encode behind them runs the default path's kernels)
# ---------------------------------------------------------------------------

HOST_RUNS = 3       # host wall times: median of this many runs
CULPRIT_KEYS = ("pixel_bound", "block_bound", "saturated", "expandable")


def host_ms(fn, runs: int = HOST_RUNS) -> tuple:
    """(median host wall ms of ``fn()``, its last result)."""
    times, result = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        result = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), result


def numpy_factor_path(fn):
    """``fn()`` with the serializer's factor sections on their NumPy path."""
    os.environ["LIMG_TPU_DISABLE_NATIVE_FACTOR"] = "1"
    try:
        return fn()
    finally:
        del os.environ["LIMG_TPU_DISABLE_NATIVE_FACTOR"]


def cli_text(args) -> str:
    """The CLI's standard output for ``args``."""
    import contextlib
    import io

    from limg_tpu_torch import cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.main(args)
    return text.getvalue()


def printed_culprits(text: str) -> dict:
    """The four counts of the culprit block the CLI printed."""
    counts = {k: int(m.group(1)) for k in CULPRIT_KEYS
              for m in [re.search(rf"^{k}\s*:\s*(\d+) \(", text, re.MULTILINE)] if m}
    if "CULPRIT info:" not in text or len(counts) != len(CULPRIT_KEYS):
        raise AssertionError(f"no culprit block in the CLI's output: {text!r}")
    return counts


def fixed_grid_culprits(img, cfg, device) -> dict:
    """The CLI's fixed-grid --diagnose refit and culprits, on ``device``."""
    import torch
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.ops.crush import find_shifts
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.fit import fit_blocks
    from limg_tpu_torch.utils.diagnostics import crush_culprits

    px, mask, _ = layout.blockify(torch.from_numpy(img).to(device))
    d = fit_blocks(px, mask, cfg.channels)
    f8 = quantize_factors(*extract_factors(px, d, cfg.channels))
    shifts, _ = find_shifts(px, mask, f8, d, cfg)
    return crush_culprits(px, mask, f8, d, shifts, cfg)


def phase_ltp1(device, smi: str, size=(2160, 3840)):
    """The LTP1 stream and the diagnostics: the default encode with
    return_state=True at 4K RGB and RGBA (dithering on), its kernels counted
    from 0; the stream on the native and the NumPy factor path, entropy on
    and off, equal bytes, decoding to the encode's image bit for bit; the
    JAX-recorded streams of the fixture states, from JAX's state and from
    the port's encode on the card; an RD stream; the CLI's --write-ltp1,
    --decode-ltp1 and --diagnose (merged and --fixed-grid)."""
    import tempfile

    import torch
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig, bitstream, native
    from limg_tpu_torch.kernels import launch
    from limg_tpu_torch.utils.diagnostics import crush_culprits_merged
    from tools import record_torch_ltp1_reference as lrec
    from tools import record_torch_merged_reference as mrec
    from tools import record_torch_natural_reference as nrec
    from tools.record_torch_reference import case_images

    log("== phase 3f: LTP1 stream and diagnostics (encode_image_merged(return_state=True), "
        "bitstream, utils.diagnostics, the CLI's --write-ltp1 / --decode-ltp1 / --diagnose)")
    for var in ("LIMG_TPU_DISABLE_NATIVE", "LIMG_TPU_DISABLE_NATIVE_FACTOR"):
        if os.environ.get(var):
            raise AssertionError(f"{var} is set: the native runtime must run here")
    if not (native.available() and native.factor_kernels_available()):
        raise AssertionError(f"the native host runtime did not build: {native.build_log}")
    log(f"  native runtime {native.library_path().name} ({run_text(['g++', '--version'])
                                                         .splitlines()[0]}, "
        f"{' '.join(native.GXX_FLAGS)})")
    h, w = size
    images = case_images(h, w)
    launch.reset_launches()
    encodes = {}
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        out, state = limg_tpu_torch.encode_image_merged(img, cfg, return_state=True,
                                                        device=device)
        encodes[lane] = (cfg, out, state)
    launched = launch_counts(MERGED_KERNELS + COALESCE_KERNELS)
    if min(launched.values()) == 0:
        raise AssertionError(f"the encode behind the stream skipped a kernel: {launched}")
    log(f"  {len(encodes)} encodes (dithering on), launches {launched}")

    streams, culprits_cpu = {}, {}
    for lane, (cfg, out, state) in encodes.items():
        img = images[lane]
        blobs = {}
        for entropy in (True, False):
            blob = bitstream.serialize_from_state(state, cfg, entropy=entropy)
            if numpy_factor_path(lambda: bitstream.serialize_from_state(
                    state, cfg, entropy=entropy)) != blob:
                raise AssertionError(f"{lane} entropy={entropy}: the native and NumPy factor "
                                     f"paths write different streams")
            dec, info = bitstream.deserialize(blob)
            if not np.array_equal(dec, out["decoded"]) or info["n_runs"] != out["n_runs"]:
                raise AssertionError(f"{lane} entropy={entropy}: the stream does not decode "
                                     f"to the encode ({info})")
            blobs[entropy] = blob
        dec_np, _ = numpy_factor_path(lambda: bitstream.deserialize(blobs[True]))
        if not np.array_equal(dec_np, out["decoded"]):
            raise AssertionError(f"{lane}: the NumPy factor path decodes another image")
        streams[lane] = blobs[True]
        # the state as the device holds it: fetch + serialize, timed
        pre = limg_tpu_torch.fused_merged_pre(img, cfg, 0, MERGED_LEVELS, device=device)
        cap = limg_tpu_torch.auto_run_capacity(int(pre["n_run_blocks"]),
                                               pre["grid"].num_blocks)
        dev_out = limg_tpu_torch.fused_merged_finish(pre, cfg, 0, MERGED_LEVELS, False, cap,
                                                     return_state=True)
        dev_state = dict(height=h, width=w, num_levels=MERGED_LEVELS, channels=cfg.channels,
                         rows=dev_out["ser_rows"], q=dev_out["ser_q"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        fetch_ms, _ = host_ms(lambda: (dev_state["rows"].cpu(), dev_state["q"].cpu()))
        ser_ms, blob = host_ms(lambda: bitstream.serialize_from_state(dev_state, cfg))
        ser_np_ms, blob_np = host_ms(lambda: numpy_factor_path(
            lambda: bitstream.serialize_from_state(dev_state, cfg)))
        if blob != blobs[True] or blob_np != blob:
            raise AssertionError(f"{lane}: the device state's stream differs")
        des_ms, _ = host_ms(lambda: bitstream.deserialize(blob))
        diag_ms, culprits = host_ms(lambda: crush_culprits_merged(img, state, cfg,
                                                                  device=device))
        culprits_cpu[lane] = crush_culprits_merged(img, state, cfg, device="cpu")
        if culprits_cpu[lane] != culprits:
            raise AssertionError(f"{lane}: culprits on the card differ from the CPU's")
        log(f"  4k_{lane} host wall ms (median of {HOST_RUNS}) [{smi}]: state fetch + "
            f"serialize_from_state {ser_ms:.1f} (NumPy factor path {ser_np_ms:.1f}; the "
            f"fetch alone {fetch_ms:.1f}), "
            f"deserialize {des_ms:.1f}, crush_culprits_merged {diag_ms:.1f}")
        log(f"  4k_{lane} stream {len(blob)} bytes = {len(blob) * 8 / (h * w)!r} real bpp "
            f"(entropy off {len(blobs[False])} bytes = {len(blobs[False]) * 8 / (h * w)!r}); "
            f"the encode's estimate mean_bpp {out['mean_bpp']!r}; {out['n_runs']} runs; "
            f"culprits {culprits}")

    # the streams JAX wrote from its fixture states: from JAX's state and
    # from the port's encode of each case on the card (dithering off)
    refs = lrec.reference_streams()
    fx = np.load(NATURAL_FIXTURE)
    for name in lrec.STATE_CASES:
        make, levels, over, coalesce, _ = nrec.CASES[name]
        cfg = EncodeConfig(**mrec.config_kwargs(over))
        _, port_state = limg_tpu_torch.encode_image_merged(make(), cfg, num_levels=levels,
                                                           coalesce=coalesce, return_state=True,
                                                           device=device)
        for key, entropy in lrec.ENTROPY.items():
            for src, state in (("JAX", lrec.state_of(fx, name)), ("port", port_state)):
                got = lrec.digest(bitstream.serialize_from_state(state, cfg, entropy=entropy))
                if got != refs[name][key]:
                    raise AssertionError(f"{name} {key}, {src} state: {got} against JAX's "
                                         f"{refs[name][key]}")
    log(f"  {len(lrec.STATE_CASES)} fixture states, entropy on and off: the streams of JAX's "
        f"state and of the port's encode on the card have JAX's SHA-256 and length")

    # the RD policy's stream, the encode charging the real header cost
    cfg, _, _ = encodes["rgb"]
    out, state = limg_tpu_torch.encode_image_merged(
        images["rgb"], cfg, merge_policy="rd", return_state=True,
        rd_header_bits=bitstream.region_header_bits(cfg.channels), device=device)
    blob = bitstream.serialize(images["rgb"], cfg, merge_policy="rd", device=device)
    dec, info = bitstream.deserialize(blob)
    if blob != bitstream.serialize_from_state(state, cfg) or not np.array_equal(
            dec, out["decoded"]):
        raise AssertionError("the RD stream does not round-trip to its encode")
    log(f"  4k_rgb RD: stream {len(blob)} bytes = {len(blob) * 8 / (h * w)!r} real bpp, "
        f"decodes to the encode bit for bit (mean_bpp {out['mean_bpp']!r})")

    # the CLI on the card: one encode writes the stream and the culprits,
    # then the stream decodes; the fixed grid's culprits on a small image
    cfg, out, state = encodes["rgb"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            np.save("img4k.npy", images["rgb"])
            text = cli_text(["img4k.npy", "--no-output", "--write-ltp1", "s.ltp1",
                             "--diagnose"])
            with open("s.ltp1", "rb") as f:
                if f.read() != streams["rgb"]:
                    raise AssertionError("the CLI's stream differs from the encode's")
            cli_counts = printed_culprits(text)
            decode_text = cli_text(["--decode-ltp1", "s.ltp1"])
            if not np.array_equal(native.read_tga("limg_decoded.tga"), out["decoded"]):
                raise AssertionError("limg_decoded.tga differs from the encode's image")
            small = small_image()
            np.save("small.npy", small)
            fixed_counts = printed_culprits(cli_text(["small.npy", "--fixed-grid",
                                                      "--diagnose", "--no-output"]))
        finally:
            os.chdir(cwd)
    want = culprits_cpu["rgb"]
    if cli_counts != {k: want[k] for k in CULPRIT_KEYS}:
        raise AssertionError(f"CLI --diagnose: {cli_counts} against {want} on the CPU")
    want_fixed = fixed_grid_culprits(small, cfg, "cpu")
    if fixed_counts != {k: want_fixed[k] for k in CULPRIT_KEYS}:
        raise AssertionError(f"CLI --fixed-grid --diagnose: {fixed_counts} against "
                             f"{want_fixed} on the CPU")
    log(f"  cli: {[ln for ln in text.splitlines() if ln.startswith('Wrote')]}; "
        f"{decode_text.splitlines()[0]}; limg_decoded.tga equals the encode's image; "
        f"--diagnose {cli_counts}, --fixed-grid --diagnose {fixed_counts} (as on the CPU)")
    log("phase 3f ok")


# ---------------------------------------------------------------------------
# Run buffers of the dense levels' regions (tests/test_torch_kernel_cuda.py's
# cases for the segment and region encodes from P = 256 on)
# ---------------------------------------------------------------------------

# lanes of the seeded buffers at each P: several CTAs of each P's tile
SEGMENT_LANES = {256: 300, 1024: 100, 4096: 40}


def region_run_buffer(rng, p: int, n: int, ch: int, device, spans=None, empty_tail: int = 0,
                      saturate: bool = False):
    """A run buffer of n regions of p pixels (segment_encode's inputs): half
    smooth, some regions with no and some with half their pixels members,
    segments of 1-8 regions (or of ``spans``), the last ``empty_tail``
    lanes with no member; ``saturate`` makes lane 0 a single-region segment
    of 15/16 white and 1/16 black pixels, whose unscaled error sum at axis
    A's shift 8 passes 2^31."""
    import torch

    px = rng.integers(0, 256, (4, p, n), np.int64)
    px[:, :, : n // 2] = (px[:, :, : n // 2] // 32) * 32
    if ch == 3:
        px[3] = 0
    mask = np.ones((p, n), bool)
    mask[:, rng.integers(1, n, max(1, n // 10))] = False
    mask[p // 2:, rng.integers(1, n, max(1, n // 10))] = False
    if spans is None:
        seg = seg_map(rng, n, 8)
    else:
        seg = np.concatenate([np.full(k, s, np.int32) for k, s in
                              zip(spans, np.cumsum([0] + list(spans))[:-1])])
    if saturate:
        px[:, :, 0] = 255
        px[:, : p // 16, 0] = 0
        if ch == 3:
            px[3, :, 0] = 0
        mask[:, 0] = True
        seg[1:][seg[1:] == 0] = 1
    if empty_tail:
        mask[:, n - empty_tail:] = False
    words = px[0] | (px[1] << 8) | (px[2] << 16) | (px[3] << 24)
    words = np.where(words >= 2**31, words - 2**32, words).astype(np.int32)
    blocks = rng.permutation(4 * n)[:n].astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (words, mask, seg, blocks))


def every_lane_a_member(rng, p: int, n: int, ch: int, device):
    """A run buffer of n single-region segments whose pixels are all
    members: the most segments the segment encode lists (a cluster each)."""
    import torch

    words, mask, seg, blocks = region_run_buffer(rng, p, n, ch, device, spans=[1] * n)
    return words, torch.ones_like(mask), seg, blocks


# the dense path's levels 4-6 (128x128, 256x256 and 512x512 px regions, P =
# 16,384, 65,536 and 262,144): the region encode's cluster kernel and the
# segment encode's <CH, 8> ones
LARGE_REGION_LANES = {16384: 10, 65536: 5, 262144: 3}
# a segment of one region, one of several, and a tail of lanes with no member
LARGE_SEGMENT_SPANS = {16384: [1, 5, 1, 2, 1], 65536: [1, 3, 1, 1], 262144: [1, 2, 1]}
LARGE_SETTINGS = [("ladder", 3, False), ("ladder", 3, True), ("ladder", 1, True),
                  ("exhaustive", 2, False), ("guess", 3, True), ("none", 3, False)]
# a ragged image: at each size a grid cut by both edges (300 x 700 px)
LARGE_IMAGE = (300, 700)
# level 9's regions, each more items than a 16-CTA cluster has warps (the
# segment encode takes them in rounds; the region encode's CTAs read their
# shares of 256 chunks from device memory pass by pass), and the settings
# held there
ROUNDS_PIXELS = 64 << 18
ROUNDS_SETTINGS = [("ladder", 3, True), ("ladder", 1, False), ("guess", 3, False),
                   ("none", 3, True)]


# ---------------------------------------------------------------------------
# Phase 3g: the dense path, --fixed-grid --write-ltp1, the legacy encoder
# ---------------------------------------------------------------------------

def check_dense_against_fixture(name: str, out: dict, state: dict, fx, n_px: int,
                                agree_min: float = OWNER_AGREE):
    """One 4K dense match encode against the JAX dense encode's record
    (tests/fixtures/torch_port_dense_reference.npz, or
    torch_port_levels_reference.npz): stats, owner map and run flags (equal
    on at least ``agree_min`` of the blocks); returns whether the state is
    JAX's (its SHA-256)."""
    from tools import record_torch_dense_reference as drec

    hist_l1 = int(np.abs(out["bits_histogram"] - fx[f"{name}.bits_histogram"]).sum())
    ref_alive = fx[f"{name}.alive_counts"]
    alive_rel = np.abs(out["alive_counts"] - ref_alive) / np.maximum(ref_alive, 1)
    owner = out["owner_px"][::8, ::8].reshape(-1)
    agree = float((owner == fx[f"{name}.owner"]).mean())
    nb = owner.size
    runs_agree = float((state["rows"][-1].astype(bool)
                        == np.unpackbits(fx[f"{name}.run_applied"])[:nb].astype(bool)).mean())
    d_psnr = out["psnr"] - float(fx[f"{name}.psnr"])
    d_bpp = out["mean_bpp"] - float(fx[f"{name}.mean_bpp"])
    ref_runs = int(fx[f"{name}.n_runs"])
    same_state = drec.state_digest(state) == str(fx[f"{name}.state_sha256"])
    log(f"  {name}: psnr {out['psnr']!r} (JAX {float(fx[f'{name}.psnr'])!r}, diff {d_psnr:+.5f} "
        f"dB) bpp {out['mean_bpp']!r} (diff {d_bpp:+.5f}) alive {out['alive_counts'].tolist()} "
        f"(JAX {ref_alive.tolist()}) runs {out['n_runs']} (JAX {ref_runs}) hist L1 {hist_l1} px "
        f"owner agreement {agree!r} run-flag agreement {runs_agree!r}, state "
        f"{'equal to' if same_state else 'differs from'} JAX's")
    if not (abs(d_psnr) <= NODITHER_PSNR_DB and abs(d_bpp) <= NODITHER_BPP
            and hist_l1 <= HIST_L1_FRAC * n_px and (alive_rel <= ALIVE_FRAC).all()
            and agree >= agree_min and runs_agree >= agree_min
            and abs(out["n_runs"] - ref_runs) <= RUNS_FRAC * ref_runs):
        raise AssertionError(f"{name}: outside the tolerance of the JAX dense encode")
    return same_state


def phase_main_path_dense(device):
    """encode_image_merged(fused=False) at 4K RGB and RGBA, 1 and 3 levels
    (match) and 3 (RD), and one 4-level encode, its kernels' launches
    counted from 0 (segment_encode at every P of the levels); the CLI's
    --fixed-grid --write-ltp1 and --decode-ltp1; encode_legacy at 4K."""
    import tempfile

    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig, LegacyConfig, bitstream, native
    from limg_tpu_torch.kernels import launch
    from tools import record_torch_dense_reference as drec
    from tools.record_torch_reference import case_images

    log("== phase 3g: dense path (encode_image_merged(fused=False)), --fixed-grid "
        "--write-ltp1, encode_legacy")
    fx, rdfx = np.load(DENSE_FIXTURE), np.load(RD_FIXTURE)
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    launch.reset_launches()
    n_encodes, outs = 0, {}
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False)
        for levels in (1, MERGED_LEVELS):
            name = f"4k_{lane}_l{levels}"
            t0 = time.perf_counter()
            out, state = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=levels,
                                                            fused=False, return_state=True,
                                                            device=device)
            secs = time.perf_counter() - t0
            n_encodes += 1
            if out["decoded"].shape != (h, w, 4) or not np.isfinite(out["psnr"]):
                raise AssertionError(f"{name}: decoded {out['decoded'].shape}, psnr {out['psnr']}")
            log(f"  {name} dense: encode_image_merged {secs * 1e3:.1f} ms wall (host copies "
                f"and the state's fetch included)")
            same = check_dense_against_fixture(name, out, state, fx, h * w)
            blob = bitstream.serialize_from_state(state, cfg)
            dec, _ = bitstream.deserialize(blob)
            if not np.array_equal(dec, out["decoded"]):
                raise AssertionError(f"{name}: the stream does not decode to the encode")
            if same and (drec.stream_digest(blob) != str(fx[f"{name}.stream_sha256"])
                         or len(blob) != int(fx[f"{name}.stream_len"])):
                raise AssertionError(f"{name}: the state is JAX's but the stream is not")
            log(f"    stream {len(blob)} bytes (JAX {int(fx[f'{name}.stream_len'])}), "
                f"{'JAX' + chr(39) + 's SHA-256' if same else 'another state'}; decodes to the "
                f"encode")
            outs[(lane, levels)] = out
        # the RD policy, against JAX's dense RD encode (torch_port_rd_reference.npz)
        name = f"4k_{lane}_l{MERGED_LEVELS}"
        out = limg_tpu_torch.encode_image_merged(img, cfg, num_levels=MERGED_LEVELS,
                                                 merge_policy="rd", rd_lambda=RD_LAMBDA,
                                                 fused=False, device=device)
        n_encodes += 1
        ref = {k: rdfx[f"{name}_dense.{k}"] for k in ("psnr", "mean_bpp", "alive_counts",
                                                      "n_runs")}
        d_psnr, d_bpp = out["psnr"] - float(ref["psnr"]), out["mean_bpp"] - float(ref["mean_bpp"])
        alive_rel = (np.abs(out["alive_counts"] - ref["alive_counts"])
                     / np.maximum(ref["alive_counts"], 1))
        log(f"  {name} dense RD: psnr {out['psnr']!r} (JAX {float(ref['psnr'])!r}, diff "
            f"{d_psnr:+.5f} dB) bpp {out['mean_bpp']!r} (diff {d_bpp:+.5f}) kept "
            f"{out['alive_counts'].tolist()} (JAX {ref['alive_counts'].tolist()}) runs "
            f"{out['n_runs']} (JAX {int(ref['n_runs'])})")
        if not (abs(d_psnr) <= NODITHER_PSNR_DB and abs(d_bpp) <= NODITHER_BPP
                and (alive_rel <= ALIVE_FRAC).all()
                and abs(out["n_runs"] - int(ref["n_runs"])) <= RUNS_FRAC * int(ref["n_runs"])):
            raise AssertionError(f"{name} dense RD: outside the tolerance of the JAX encode")
    # 4 levels: level 3's 64x64 px regions through encode_region_p4096 and
    # segment_encode at P = 4096
    cfg = EncodeConfig(error_factor=100, dithering=False)
    out = limg_tpu_torch.encode_image_merged(images["rgb"], cfg, num_levels=4, fused=False,
                                             device=device)
    n_encodes += 1
    ref = outs[("rgb", MERGED_LEVELS)]
    log(f"  4k_rgb_l4 dense: psnr {out['psnr']!r} bpp {out['mean_bpp']!r} alive "
        f"{out['alive_counts'].tolist()} runs {out['n_runs']} (3 levels: psnr {ref['psnr']!r} "
        f"bpp {ref['mean_bpp']!r})")
    if (len(out["alive_counts"]) != 4 or abs(out["psnr"] - ref["psnr"]) > LEVELS4_PSNR_DB
            or abs(out["mean_bpp"] - ref["mean_bpp"]) > LEVELS4_BPP):
        raise AssertionError("the 4-level dense encode is off the 3-level one")
    launched = launch_counts(DENSE_KERNELS)
    if min(launched.values()) == 0:
        raise AssertionError(f"the dense path skipped a kernel: launches {launched}")
    log(f"  {n_encodes} encodes, launches {launched}")

    # the CLI: --fixed-grid --write-ltp1 writes a 1-level merged encode's
    # stream, --decode-ltp1 gives that encode's image bit for bit
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            np.save("img4k.npy", images["rgb"])
            text = cli_text(["img4k.npy", "--fixed-grid", "--no-output", "--write-ltp1",
                             "f.ltp1"])
            decode_text = cli_text(["--decode-ltp1", "f.ltp1"])
            decoded = native.read_tga("limg_decoded.tga")
        finally:
            os.chdir(cwd)
    want = limg_tpu_torch.encode_image_merged(images["rgb"], EncodeConfig(), num_levels=1,
                                              device=device)["decoded"]
    if not np.array_equal(decoded, want):
        raise AssertionError("--fixed-grid --write-ltp1: the stream does not decode to the "
                             "1-level encode's image")
    log(f"  cli --fixed-grid --write-ltp1: {[ln for ln in text.splitlines() if 'Wrote' in ln]}; "
        f"{decode_text.splitlines()[0]}; limg_decoded.tga equals the 1-level encode's image")

    # the legacy encoder: on the card at 4K; on a small image equal to its
    # run on the CPU (plain PyTorch on both, dithering on)
    t0 = time.perf_counter()
    leg = limg_tpu_torch.encode_legacy(images["rgb"], LegacyConfig(), device=device)
    secs = time.perf_counter() - t0
    if leg["decoded"].shape != (h, w, 4) or not 0 < leg["coverage"] <= 100 \
            or not np.isfinite(leg["psnr"]):
        raise AssertionError(f"encode_legacy at 4K: {leg['decoded'].shape}, coverage "
                             f"{leg['coverage']}, psnr {leg['psnr']}")
    small = images["rgba"][:256, :384]
    on_card = limg_tpu_torch.encode_legacy(small, LegacyConfig(has_alpha=True), device=device)
    on_cpu = limg_tpu_torch.encode_legacy(small, LegacyConfig(has_alpha=True), device="cpu")
    differ = [k for k in ("decoded", "factors", "shift", "covered")
              if not np.array_equal(on_card[k], on_cpu[k])]
    if differ:
        raise AssertionError(f"encode_legacy 256x384 RGBA on the card differs from the CPU in "
                             f"{differ}")
    log(f"  encode_legacy 4K RGB on the card: {secs * 1e3:.1f} ms wall, coverage "
        f"{leg['coverage']!r}%, grown {leg['grown_px']} px, avg bits {leg['avg_bits']!r}, psnr "
        f"{leg['psnr']!r}; 256x384 RGBA equal to its CPU run")
    log("phase 3g ok")


def phase_main_path_levels(device):
    """encode_image_merged(num_levels=5) at 4K RGB and RGBA and
    num_levels=6 at 4K RGB (5 levels and more take the dense path), their
    kernels' launches counted from 0 (the region and segment encodes at P =
    16,384 and 65,536 among them), against the JAX dense encodes of
    tests/fixtures/torch_port_levels_reference.npz: owners and run flags
    equal on 99.9% of the blocks, PSNR, bpp, histogram, level counts and
    n_runs within the dense phase's tolerances; each state's stream is
    written (JAX's SHA-256 where the state is JAX's) and refused by
    deserialize, as the JAX package's reader refuses 5 levels."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig, bitstream
    from limg_tpu_torch.kernels import launch
    from tools import record_torch_dense_reference as drec
    from tools import record_torch_levels_reference as lrec
    from tools.record_torch_reference import case_images

    log("== phase 3i: 5- and 6-level encodes at 4K (the dense path's 128x128 and 256x256 px "
        "regions)")
    fx = np.load(LEVELS_FIXTURE)
    meta = json.loads(str(fx["meta"]))
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    launch.reset_launches()
    for name, (lane, levels, _) in lrec.FULL_CASES.items():
        cfg = EncodeConfig(**meta["cases"][name]["config"])
        t0 = time.perf_counter()
        out, state = limg_tpu_torch.encode_image_merged(images[lane], cfg, num_levels=levels,
                                                        return_state=True, device=device)
        secs = time.perf_counter() - t0
        if out["decoded"].shape != (h, w, 4) or not np.isfinite(out["psnr"]):
            raise AssertionError(f"{name}: decoded {out['decoded'].shape}, psnr {out['psnr']}")
        log(f"  {name}: encode_image_merged {secs * 1e3:.1f} ms wall (host copies and the "
            f"state's fetch included)")
        same = check_dense_against_fixture(name, out, state, fx, h * w, LEVELS_AGREE)
        blob = bitstream.serialize_from_state(state, cfg)
        if same and (drec.stream_digest(blob) != str(fx[f"{name}.stream_sha256"])
                     or len(blob) != int(fx[f"{name}.stream_len"])):
            raise AssertionError(f"{name}: the state is JAX's but the stream is not")
        try:
            bitstream.deserialize(blob)
        except ValueError as e:
            if "bad dimensions/levels" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: deserialize took a {levels}-level stream, which the "
                                 f"JAX package's reader refuses")
        log(f"    stream {len(blob)} bytes (JAX {int(fx[f'{name}.stream_len'])}), "
            f"{'JAX' + chr(39) + 's SHA-256' if same else 'another state'}; deserialize refuses "
            f"it as JAX's does")
    launched = launch_counts(LEVELS_KERNELS)
    if min(launched.values()) == 0:
        raise AssertionError(f"the 5- and 6-level encodes skipped a kernel: launches {launched}")
    log(f"  {len(lrec.FULL_CASES)} encodes, launches {launched}")
    log("phase 3i ok")


# the scatter-form segment refit and crush (phase 3j): each 4K map's search
# under every crush mode and these num_factors
SCATTER_MODES = ("ladder", "exhaustive", "guess")
SCATTER_FACTORS = (3, 2)
# the CPU version is held to the card on the first segments of a map (in id
# order) whose members number at most this many blocks, by crush mode (the
# whole 4K map for the fit and the guess mode: the CPU's exhaustive search
# of 129,600 blocks would take minutes a call, its ladder tens of seconds)
SCATTER_CPU_BLOCKS = {"ladder": 8192, "exhaustive": 1024, "guess": 129600}


def scatter_maps(img, device) -> dict:
    """Phase 3j's two segment maps of a 4K image's block grid, {name: (seg_id
    (NB,) int32, S)}: the default 3-level encode's owner regions, numbered in
    row-major block order (``owner_segment_map``), and a seeded random map,
    a quarter as many segments as blocks, some of them empty."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.config import BLOCK_SIZE

    cfg = EncodeConfig(error_factor=100, has_alpha=img.shape[2] == 4)
    owner = limg_tpu_torch.encode_image_merged(img, cfg, device=device)["owner_px"]
    owner_seg, owner_s = owner_segment_map(owner[::BLOCK_SIZE, ::BLOCK_SIZE])
    nb = owner_seg.size
    rand = np.random.default_rng(17).integers(0, nb // 4, nb).astype(np.int32)
    return {"owner": (owner_seg, owner_s), "random": (rand, nb // 4)}


def segment_subset(seg: np.ndarray, s: int, max_blocks: int) -> tuple:
    """The first k segments of ``seg`` whose members number at most
    ``max_blocks`` blocks (at least one segment): (their blocks, in block
    order, as an index array; those blocks' ids; k)."""
    k = max(1, int(np.searchsorted(np.cumsum(np.bincount(seg, minlength=s)), max_blocks,
                                   side="right")))
    blocks = np.nonzero(seg < k)[0]
    return blocks, seg[blocks], k


def seg_fold_cases(maps: dict, nb: int) -> dict:
    """seg_sum_fold_kernel's cases: {name: (float32 rows, seg_id, S)}: the
    fit's (3, NB) rows on each 4K map, magnitudes over seven decades so a
    sum's order shows in its bits, 81 rows (the exhaustive chunk's), one
    segment of every block (one thread folds 129,600 values), most segments
    empty, and a map with ids past the buffer's blocks."""
    rng = np.random.default_rng(23)

    def rows(r, n):
        return (rng.standard_normal((r, n)) * 10.0 ** rng.integers(-3, 4, (r, n))).astype(
            np.float32)

    cases = {f"{name} map (3, {nb})": (rows(3, nb), seg, s) for name, (seg, s) in maps.items()}
    seg_r, s_r = maps["random"]
    cases[f"random map (81, {nb})"] = (rows(81, nb), seg_r, s_r)
    cases[f"one segment (1, {nb})"] = (rows(1, nb), np.zeros(nb, np.int32), 1)
    cases["most segments empty (4, 1000)"] = (rows(4, 1000),
                                              rng.integers(0, 2000, 1000).astype(np.int32), 2000)
    cases["ids past the blocks (2, 37)"] = (rows(2, 37), rng.integers(40, 50, 37).astype(np.int32),
                                            64)
    return cases


def compare_seg_fold(device, cases: dict) -> tuple:
    """seg_sum_fold_kernel against its plain version (the CPU's left fold)
    on ``cases``, bit-equal, and against a second launch; and PyTorch's
    ``index_add_`` on the card against the fold: the sums it gets in another
    order. Returns (max abs diff, the index_add_ finding)."""
    import torch
    from limg_tpu_torch.kernels.seg_fold import seg_sum_fold_kernel, seg_sum_fold_reference
    from limg_tpu_torch.ops.segments import fold_plan, seg_sum_plain

    worst, finding = 0.0, {}
    for name, (x, seg, s) in cases.items():
        xt, st = torch.from_numpy(x), torch.from_numpy(seg)
        want = seg_sum_fold_reference(xt, st, s)
        xd, sd = xt.to(device), st.to(device)
        got = seg_sum_fold_kernel(xd, sd, s)
        again = seg_sum_fold_kernel(xd, sd, s, fold_plan(sd, s))
        torch.cuda.synchronize(device)
        worst = max(worst, compare_bits((got.cpu(),), (want,)))
        if not torch.equal(got, again):
            raise AssertionError(f"seg_sum_fold {name}: two launches differ")
        atomics = [seg_sum_plain(xd, sd, s).cpu() for _ in range(2)]
        finding[name] = (int((atomics[0] != want).sum()), int((atomics[0] != atomics[1]).sum()),
                         want.numel())
    return worst, finding


def phase_main_path_scatter(device):
    """The scatter-form segment refit and crush at 4K RGB and RGBA
    (ops/segments.py ``fit_segments`` / ``find_shifts_segments``, contiguous
    False) on two maps (``scatter_maps``): the fit, the factors on
    ``gather_decomp``, and the search under every crush mode at num_factors
    3 and 2; seg_sum_fold and crush_eval_rows counted from 0; each result
    equal to a second run on the card and to the CPU version (the fit on the
    whole map, the search on ``segment_subset``), empty segments (0, 0, 0)
    and 2^31 - 1; seg_sum_fold held to its plain version."""
    import torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import launch
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.fit import drop_decomposition_axes
    from limg_tpu_torch.ops.segments import find_shifts_segments, fit_segments, gather_decomp
    from tools.record_torch_reference import case_images

    log("== phase 3j: scatter-form segment refit and crush at 4K (fit_segments / "
        "find_shifts_segments, contiguous=False)")
    images = case_images(2160, 3840)
    inputs = {}
    for lane, img in images.items():
        px, mask, _ = layout.blockify(torch.from_numpy(img).to(device))
        for name, (seg, s) in scatter_maps(img, device).items():
            inputs[(lane, name)] = (px, mask, seg, s)
    nb = inputs[("rgb", "owner")][2].size
    log("  maps: " + ", ".join(f"{lane} {name} {s} segments, "
                               f"{int((np.bincount(seg, minlength=s) == 0).sum())} empty"
                               for (lane, name), (_, _, seg, s) in inputs.items()))

    def run(px, mask, seg_t, s, ch):
        """The main path on one map: per (num_factors, mode) the search."""
        d = fit_segments(px, mask, seg_t, s, ch)
        f8 = torch.stack(quantize_factors(*extract_factors(px, gather_decomp(d, seg_t), ch)))
        out = {"fit": d}
        for nf in SCATTER_FACTORS:
            d_nf = drop_decomposition_axes(d, nf)
            for mode in SCATTER_MODES:
                cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                   num_factors=nf)
                out[(nf, mode)] = (find_shifts_segments(px, mask, f8, d_nf, seg_t, s, cfg),
                                   d_nf, cfg)
        return out, f8

    launch.reset_launches()
    t0 = time.perf_counter()
    results = {key: run(px, mask, torch.from_numpy(seg).to(device), s, px.shape[0])
               for key, (px, mask, seg, s) in inputs.items()}
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    launched = launch_counts(("seg_sum_fold", "crush_eval_rows"))
    if min(launched.values()) == 0:
        raise AssertionError(f"the scatter refit and crush skipped a kernel: launches {launched}")
    log(f"  {len(results)} fits and {len(results) * len(SCATTER_FACTORS) * len(SCATTER_MODES)} "
        f"searches in {secs:.2f} s wall, launches {launched}")

    worst = 0.0
    for key, (out, f8) in results.items():
        t0 = time.perf_counter()
        px, mask, seg, s = inputs[key]
        seg_t, ch = torch.from_numpy(seg).to(device), px.shape[0]
        again, _ = run(px, mask, seg_t, s, ch)
        cpu = (px.cpu(), mask.cpu(), f8.cpu())
        want = fit_segments(cpu[0], cpu[1], torch.from_numpy(seg), s, ch)
        worst = max(worst, compare_bits(tuple(f.cpu() for f in out["fit"]), want),
                    compare_bits(tuple(f.cpu() for f in again["fit"]), want))
        empty = torch.from_numpy(np.bincount(seg, minlength=s) == 0)
        for nf_mode, ((shifts, err), d_nf, cfg) in ((k, v) for k, v in out.items() if k != "fit"):
            if not (torch.equal(shifts, again[nf_mode][0][0])
                    and torch.equal(err, again[nf_mode][0][1])):
                raise AssertionError(f"{key} {nf_mode}: two card runs differ")
            if shifts[:, empty.to(device)].any() or (err[empty.to(device)] != 2**31 - 1).any():
                raise AssertionError(f"{key} {nf_mode}: an empty segment was crushed")
            blocks, sub_seg, k = segment_subset(seg, s, SCATTER_CPU_BLOCKS[nf_mode[1]])
            b = torch.from_numpy(blocks)
            d_sub = type(d_nf)(*(f[..., :k].cpu() for f in d_nf))
            want_s, want_e = find_shifts_segments(cpu[0][..., b], cpu[1][:, b], cpu[2][..., b],
                                                  d_sub, torch.from_numpy(sub_seg), k, cfg)
            worst = max(worst, compare_bits((shifts[:, :k].cpu(), err[:k].cpu()),
                                               (want_s, want_e)))
        log(f"  {key}: fit bit-equal to the CPU version on all {s} segments; "
            f"{len(out) - 1} searches equal to a second card run and to the CPU version on the "
            f"first segments of at most {SCATTER_CPU_BLOCKS} blocks by mode "
            f"({time.perf_counter() - t0:.1f} s)")

    worst_f, finding = compare_seg_fold(device, seg_fold_cases(
        {name: inputs[("rgb", name)][2:] for name in ("owner", "random")}, nb))
    log(f"  seg_sum_fold vs its plain version: {len(finding)} cases, max abs diff {worst_f}")
    for name, (n_fold, n_runs, n) in finding.items():
        log(f"    index_add_ on the card, {name}: {n_fold} of {n} sums differ from the fold, "
            f"{n_runs} between two runs")

    log(f"phase 3j ok: the scatter refit and crush on the card equal the CPU version and a "
        f"second run (max abs diff {max(worst, worst_f)})")


# ---------------------------------------------------------------------------
# Bounds: bytes and operations of a call, counted from its inputs and outputs
# (each tensor read or written once) and from the kernels' code;
# h100_bench/counts/ holds a frozen copy, held equal to these at 4K by
# h100_bench/tests/test_bench_counts.py
# ---------------------------------------------------------------------------

def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (nested tuples, lists, dicts)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
        elif isinstance(o, dict):
            total += tensor_bytes(*o.values())
    return total


def axis_decode_ops(ch: int) -> int:
    """Operations of one axis's decode of one pixel (limg_common.cuh
    decode_est): a shift and a multiply of the factor, per channel a
    multiply, two adds and a shift."""
    return 2 + ch * 4


def pixel_err_ops(ch: int) -> int:
    """Operations of one pixel's error under a decode (pixel_err): per
    channel a clamp (2), a subtract and a square, the weighted sum (2 per
    channel); the pixel max and the error sum."""
    return ch * 4 + ch * 2 + 2


def eval_ops(ch: int) -> int:
    """Operations of one crush candidate on one pixel: three axes' decode
    and the error."""
    return 3 * axis_decode_ops(ch) + pixel_err_ops(ch)


def distinct_eval_work(cands) -> tuple:
    """(axis decodes, triples) that candidate shifts (K, 3, N) need, summed
    over the blocks: per block one decode per distinct (axis, shift) and one
    channel sum and error per distinct triple among its K candidates (a
    shift above 8 decodes as 8)."""
    import torch

    s = torch.clamp(cands, 0, 8).long()
    n = s.shape[2]
    decodes = sum(int(torch.zeros((9, n), dtype=torch.int32, device=s.device)
                      .scatter_(0, s[:, a], 1).sum()) for a in range(3))
    code = torch.sort(s[:, 0] * 81 + s[:, 1] * 9 + s[:, 2], dim=0).values
    triples = n + int((code[1:] != code[:-1]).sum())
    return decodes, triples


def fit_ops(ch: int) -> int:
    """Operations of the 3-axis fit and the u8 factors per pixel: the mean
    (2 per channel), three direction sweeps (centre, length, sign, scaled
    sum: ~6 per channel + 4), three projections (dot, scale: 3 per channel
    + 2), the factor extremes (6) and the factor extraction (3 per channel +
    4 per axis)."""
    return 2 * ch + 3 * (6 * ch + 4) + 3 * (3 * ch + 2) + 6 + 3 * (3 * ch + 4)


def finish_ops(ch: int) -> int:
    """Dither, crush, decode and weighted error of one pixel at the chosen
    shifts: 6 per axis (hash bits skipped), decode and error as above."""
    return 3 * 6 + eval_ops(ch)


def search_ops(cfg) -> int:
    """Operations of the crush search per pixel of a searched region, as
    far as the candidates need them. Ladder: the 25 distinct per-axis
    sweeps ((0, 0, 0), the floors of a reduced-factor mode, and each axis at
    shifts 1-8 with the others at 0) share the three axes' decode at shift 0
    (and their per-axis sums, a channel add each), so each of the 24 others
    decodes one axis; every sweep prices its error; then ``ladder_k`` full
    candidates. Exhaustive: the 729 triples, (0, 0, 0) among them. Guess:
    the four canned triples and (0, 0, 0) for the floors."""
    if not cfg.crush_bits or cfg.crush_mode == "none":
        return 0
    ch = cfg.channels
    if cfg.crush_mode == "ladder":
        sweeps = 3 * axis_decode_ops(ch) + 3 * ch + 24 * axis_decode_ops(ch) + 25 * pixel_err_ops(ch)
        return sweeps + cfg.ladder_k * eval_ops(ch)
    n = {"exhaustive": 729, "guess": 4 + (1 if cfg.num_factors < 3 else 0)}[cfg.crush_mode]
    return n * eval_ops(ch)


def encode_ops(pixels: int, searched: int, cfg) -> int:
    """A full encode of ``pixels`` pixels, ``searched`` of them members of
    the regions the crush search evaluates."""
    ch = cfg.channels
    return pixels * (fit_ops(ch) + finish_ops(ch)) + searched * search_ops(cfg)


def match_ops(pairs: int, ch: int) -> int:
    """The 27-probe merge test of ``pairs`` pairs: per probe a decode of
    three factors per channel (4 each) and a deviation sum (ch + 2)."""
    return pairs * 27 * (3 * ch * 4 + ch + 2)


def probed_pairs(rows_a, rows_b, ch: int) -> int:
    """Pairs of (7ch, N) row stacks whose merge bit needs the probes: not a
    fast accept and a ratio inside its limits (ops/match.py match_decomps;
    elsewhere the bit is known without them)."""
    from limg_tpu_torch.kernels.coalesce import _as_decomp
    from limg_tpu_torch.ops.match import match_decomps

    stats = match_decomps(_as_decomp(rows_a, ch), _as_decomp(rows_b, ch), ch)[1]
    return int((~stats["fast_accept"] & ~stats["ratio_reject"]).sum())


def neighbor_probed_pairs(plane, ch: int) -> int:
    """probed_pairs of a (7ch, by, bx) plane's real neighbour pairs: each
    block with its right and its down neighbour, where it has one."""
    n = plane.shape[0]
    return (probed_pairs(plane[:, :, 1:].reshape(n, -1), plane[:, :, :-1].reshape(n, -1), ch)
            + probed_pairs(plane[:, 1:].reshape(n, -1), plane[:, :-1].reshape(n, -1), ch))


def call_bound(ops: int, nbytes: int) -> tuple:
    """(bound ms, "bytes" or "operations") of a call."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(name: str, args, out) -> tuple:
    """The bound of the call ``name(*args)`` that returned ``out``, from the
    work its inputs need: segment_encode counts the fit, search and finish
    of the lanes that hold a member pixel and the bytes of every lane's
    mask, ids and outputs, since a lane with no member needs no fit."""
    if name in ("encode_fixed_p64", "encode_region"):
        packed, mask, cfg = args[:3]
        ops = encode_ops(packed.numel(), packed.numel(), cfg)
    elif name in ("fit_levels", "fit_levels_natural"):
        words, cfg, levels = args
        ops = levels * words.numel() * fit_ops(cfg.channels)
    elif name == "crush_eval_rows":
        # what the candidates need (distinct_eval_work); a stride-0 table
        # is read as its (K, 3) rows
        from limg_tpu_torch.kernels.crush_eval import table_of

        packed, cands, ch = args[0], args[4], args[5]
        decodes, triples = distinct_eval_work(cands)
        ops = packed.shape[0] * (decodes * axis_decode_ops(ch)
                                 + triples * (ch + pixel_err_ops(ch)))
        table = table_of(cands)
        return call_bound(ops, tensor_bytes(args[:4], out, cands if table is None else table))
    elif name in ("owner_crush", "owner_crush_natural"):
        words, cfg = args[0], args[4]
        ops = encode_ops(words.numel(), words.numel(), cfg) - words.numel() * fit_ops(cfg.channels)
    elif name == "segment_encode":
        # a lane whose segment holds no member pixel needs no fit, search or
        # decode, and its pixels need not be read: count the fit, search and
        # finish of the member lanes, every lane's mask, ids and outputs
        packed_c, mask_c, cfg = args[0], args[1], args[4]
        members = int(mask_c.any(dim=0).sum())
        ops = encode_ops(members * packed_c.shape[0], members * packed_c.shape[0], cfg)
        skipped = (packed_c.shape[1] - members) * packed_c.shape[0] * packed_c.element_size()
        return call_bound(ops, tensor_bytes(args, out) - skipped)
    elif name == "match_pairs":
        ops = match_ops(probed_pairs(*args[:3]), args[2])
    elif name == "match_neighbors":
        ops = match_ops(neighbor_probed_pairs(*args[:2]), args[1])
    elif name == "fixed_planes":
        # each word read once, each plane and image byte written once
        return call_bound(0, tensor_bytes(args[:2], out))
    elif name == "seg_sum_fold":
        # one add a member of each row; each row read once, the plan (not
        # the ids) once, each sum written once
        x, plan = args[0], args[3]
        return call_bound(x.numel(), tensor_bytes(x, plan, out))
    elif name == "seg_mixed_all":
        from limg_tpu_torch.ops.segments import scan_steps

        # the batched call (seg_scan): each problem's rows, forward and
        # backward, per step a compare, a select and an add; the finish
        ops = sum(len(p.rows) * p.seg.numel() * (2 * 3 * len(scan_steps(p.seg.numel())) + 2)
                  for p in args[0])
    else:
        raise ValueError(name)
    return call_bound(ops, tensor_bytes(args, out))


def capture_coalesce_calls(fn) -> dict:
    """Run ``fn`` with the four run-coalescing wrappers recording their
    arguments: {wrapper name: [(args, kwargs), ...]}."""
    from limg_tpu_torch import regions
    from limg_tpu_torch.kernels import coalesce as kc

    names = COALESCE_WRAPPERS
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


# the run-coalescing wrappers that regions.py calls
COALESCE_WRAPPERS = ("match_neighbors_kernel", "match_pairs_kernel", "seg_scan",
                     "segment_encode_kernel")


# ---------------------------------------------------------------------------
# Every kernel against its plain version, on the calls of phases 3-3j
# ---------------------------------------------------------------------------

# wrapper entry -> (its module in limg_tpu_torch.kernels, its plain version)
HELD_WRAPPERS = {
    "encode_blocks_kernel": ("encode_fixed", "encode_blocks_reference"),
    "fixed_planes_kernel": ("fixed_planes", "fixed_planes_reference"),
    "crush_eval_rows_kernel": ("crush_eval", "crush_eval_rows_reference"),
    "seg_sum_fold_kernel": ("seg_fold", "seg_sum_fold_reference"),
    "fit_levels_kernel": ("encode_merged", "fit_levels_reference"),
    "owner_crush_kernel": ("encode_merged", "owner_crush_reference"),
    "fit_levels_natural_kernel": ("encode_natural", "fit_levels_natural_reference"),
    "owner_crush_natural_kernel": ("encode_natural", "owner_crush_natural_reference"),
    "match_pairs_kernel": ("coalesce", "match_pairs_reference"),
    "match_neighbors_kernel": ("coalesce", "match_neighbors_reference"),
    "seg_scan": ("coalesce", "seg_scan_reference"),
    "seg_mixed_all_kernel": ("coalesce", "seg_mixed_all_reference"),
    "segment_encode_kernel": ("coalesce", "segment_encode_reference"),
}
# wrappers whose plain version is the CPU's: seg_sum_fold's left fold in
# block order is index_add_ on the CPU; on a card index_add_'s atomics add
# in another order (phase 3j)
PLAIN_ON_CPU = ("seg_sum_fold_kernel",)


def on_cpu(a):
    """``a`` with its tensors (also inside tuples and lists) on the CPU."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.cpu()
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*map(on_cpu, a))
    if isinstance(a, (tuple, list)):
        return type(a)(map(on_cpu, a))
    return a


def flat_outputs(out) -> list:
    """The tensors (and Nones) of a wrapper's output, in order."""
    import torch

    if out is None or isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat_outputs(o)]


def call_settings(args) -> tuple:
    """A call's settings: its config, flags and small integers (channels,
    levels, counts), not its tensors, seeds or dither keys."""
    from limg_tpu_torch import EncodeConfig

    return tuple(a for a in args if isinstance(a, (EncodeConfig, bool, str))
                 or (isinstance(a, int) and abs(a) < 1 << 16))


def wrapper_bound(wrapper: str, args, out) -> tuple:
    """``kernel_bound`` of one wrapper call, ``args`` bound to its signature."""
    if wrapper == "encode_blocks_kernel":
        name = "encode_fixed_p64" if args[0].shape[0] == 64 else "encode_region"
    elif wrapper == "seg_mixed_all_kernel":
        from limg_tpu_torch.kernels.coalesce import ScanProblem

        # the one seg_scan problem the wrapper launches
        x, seg_c, n_sum, init = args
        ops = "s" * n_sum + "x" * (x.shape[0] - n_sum)
        return kernel_bound("seg_mixed_all", ([ScanProblem(seg_c, list(x), ops, init)],), out)
    else:
        name = {"seg_scan": "seg_mixed_all",
                "segment_encode_kernel": "segment_encode"}.get(wrapper,
                                                               wrapper.removesuffix("_kernel"))
    return kernel_bound(name, args, out)


class HeldKernels:
    """Inside ``held()``, every kernel wrapper of HELD_WRAPPERS, wherever the
    port imported it, runs the kernel and, on the first call of each
    kernel, wrapper and settings (``call_settings``) that launches on the
    card, its plain version on the same arguments (on the CPU for
    PLAIN_ON_CPU): ``compare_outputs`` raises unless they agree. The host sync debug mode is off for the
    plain version, the compare and ``wrapper_bound``; a held call nested
    in another and the plain versions' own launches run as they are, and
    the launch counts the phases read are restored after each plain run.

    ``launches``: the paths' kernel launches by name (not the plain
    versions'); ``rows``: per kernel name the calls held, the largest
    difference and the largest held call's bound."""

    def __init__(self):
        import collections
        import threading

        self.launches = collections.Counter()
        self.rows: dict = {}
        self.local = threading.local()

    def _hold(self, names, wrapper: str, plain, args, out) -> None:
        import torch
        from limg_tpu_torch.kernels import launch

        mode = torch.cuda.get_sync_debug_mode()
        counts = launch.launches.copy()
        torch.cuda.set_sync_debug_mode(0)
        self.local.plain = True
        try:
            got = flat_outputs(out)
            if wrapper in PLAIN_ON_CPU:
                want = [w if w is None else w.to(g.device)
                        for g, w in zip(got, flat_outputs(plain(*map(on_cpu, args))))]
            else:
                want = flat_outputs(plain(*args))
            if len(got) != len(want):
                raise AssertionError(f"{len(got)} outputs against {len(want)}")
            err = compare_outputs(got, want)
            ms, by = wrapper_bound(wrapper, args, out)
        except AssertionError as e:
            raise AssertionError(f"{'+'.join(names)} ({wrapper}) against its plain version: "
                                 f"{e}") from None
        finally:
            self.local.plain = False
            torch.cuda.set_sync_debug_mode(mode)
            launch.launches.clear()
            launch.launches.update(counts)
        for name in names:
            row = self.rows.setdefault(name, {"held": 0, "max_abs_err": 0.0, "bound_ms": 0.0,
                                              "bound_by": by})
            row["held"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if ms > row["bound_ms"]:
                row["bound_ms"], row["bound_by"] = ms, by

    def _spy(self, wrapper: str, kernel, plain, seen: set):
        import inspect

        from limg_tpu_torch.kernels import launch

        signature = inspect.signature(kernel)

        def call(*args, **kwargs):
            if getattr(self.local, "inside", False):
                return kernel(*args, **kwargs)
            self.local.inside = True
            try:
                before = launch.launches.copy()
                out = kernel(*args, **kwargs)
                names = sorted(launch.launches - before)
                bound = signature.bind(*args, **kwargs)
                bound.apply_defaults()
                args = tuple(bound.arguments.values())
                key = (tuple(names), wrapper, call_settings(args))
                if names and key not in seen:
                    seen.add(key)
                    self._hold(names, wrapper, plain, args, out)
                return out
            finally:
                self.local.inside = False
        return call

    @contextlib.contextmanager
    def held(self):
        """Hold the wrappers (each kernel, wrapper and settings once)."""
        import importlib

        from limg_tpu_torch.kernels import launch

        seen: set = set()
        spies = {}
        for wrapper, (module, plain) in HELD_WRAPPERS.items():
            mod = importlib.import_module(f"limg_tpu_torch.kernels.{module}")
            kernel = getattr(mod, wrapper)
            spies[id(kernel)] = (kernel, self._spy(wrapper, kernel, getattr(mod, plain), seen))
        patched = []
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("limg_tpu_torch"):
                for attr, val in list(vars(mod).items()):
                    if id(val) in spies and spies[id(val)][0] is val:
                        setattr(mod, attr, spies[id(val)][1])
                        patched.append((mod, attr, val))
        launch_call = launch.call

        def counted_call(lib, fn_name, kernel, device, *args):
            launch_call(lib, fn_name, kernel, device, *args)
            if not getattr(self.local, "plain", False):
                self.launches[kernel] += 1

        launch.call = counted_call
        try:
            yield self
        finally:
            launch.call = launch_call
            for mod, attr, val in patched:
                setattr(mod, attr, val)

    def report(self) -> dict:
        """{kernel: launches, calls held, max_abs_err, bound}; raises if a
        kernel the paths launched was never held."""
        unheld = sorted(set(self.launches) - set(self.rows))
        if unheld:
            raise AssertionError(f"launched but never held to a plain version: {unheld}")
        return {name: {"launches": n, **self.rows[name]}
                for name, n in sorted(self.launches.items())}


# ---------------------------------------------------------------------------
# Phase 3h: corpus and multi-device encode (limg_tpu_torch.parallel)
# ---------------------------------------------------------------------------

MULTICHIP_EXPECTED = os.path.join(ROOT, "MULTICHIP_EXPECTED.json")


def dryrun_image(h: int = 256, w: int = 256) -> np.ndarray:
    """The multichip dry run's synthetic image: a copy of
    ``__graft_entry__._test_image``, which imports nothing of JAX but is
    the JAX package's (a tier-1 test holds the two equal)."""
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            40 + 150 * x / w,
            30 + 180 * y / h,
            128 + 90 * np.sin(x / 7.0) * np.cos(y / 5.0),
            np.full((h, w), 255.0),
        ],
        axis=-1,
    )
    img[:h // 4, :w // 4, :3] += rng.normal(0, 12, (h // 4, w // 4, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def multichip_gate(n_devices: int, device) -> dict:
    """``__graft_entry__.dryrun_multichip``'s three paths on the port's mesh
    (8 images of 64x64 sharded, one 64x128 image block-sharded, the dense
    merged corpus at 3 levels with dithering on), each (psnr, bpp) held to
    MULTICHIP_EXPECTED.json within its tolerance."""
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.parallel import mesh

    with open(MULTICHIP_EXPECTED) as f:
        rec = json.load(f)
    cfg = EncodeConfig(error_factor=100, crush_mode="guess")
    images = np.stack([dryrun_image(64, 64) for _ in range(rec["n_devices"])])
    out = mesh.encode_corpus_sharded(images, cfg, n_devices=n_devices, device=device)
    img, psnr, bpp = mesh.encode_image_blocks_sharded(dryrun_image(64, 128), cfg,
                                                      n_devices=n_devices, device=device)
    if img.shape != (64, 128, 3):
        raise AssertionError(f"blocks-sharded decode {img.shape}")
    merged = mesh.encode_corpus_sharded_merged(images, EncodeConfig(error_factor=100),
                                               n_devices=n_devices, num_levels=3, fused=False,
                                               device=device)
    got = {"corpus": (out["mean_psnr"], float(out["bpp"].mean())), "blocks": (psnr, bpp),
           "merged": (merged["mean_psnr"], float(merged["bpp"].mean()))}
    tol = rec["tolerance"]
    failures = []
    for name, (g_psnr, g_bpp) in got.items():
        want = rec["paths"][name]
        log(f"  multichip {name} ({n_devices}-device {device} mesh): psnr {g_psnr!r} dB "
            f"(expected {want['psnr']}), bpp {g_bpp!r} (expected {want['bpp']})")
        if abs(g_psnr - want["psnr"]) > tol["psnr_db"] or abs(g_bpp - want["bpp"]) > tol["bpp"]:
            failures.append(name)
    if failures:
        raise AssertionError(f"multichip paths outside MULTICHIP_EXPECTED.json: {failures}")
    return got


CORPUS_N, STREAM_N = 8, 32        # images of the fixed-grid / merged corpus, files streamed
CORPUS_HW, MIXED_HW = (1080, 1920), (720, 1280)
PSNR_DB_EXACT = 1e-4              # a corpus's float32 PSNR against encode_image's float64


def corpus_images(n: int, hw=None, first: int = 0) -> np.ndarray:
    """(n, H, W, 3) uint8: tools/make_test_image.make_4k at seeds first,
    first + 1, ..., one thread each; ``hw`` defaults to CORPUS_HW."""
    from tools.make_test_image import make_4k

    hw = hw or CORPUS_HW
    with ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(lambda i: make_4k(*hw, seed=i), range(first, first + n))))


def opaque(img: np.ndarray) -> np.ndarray:
    """RGB -> RGBA with alpha 0xFF: what a TGA file of it reads back as."""
    return np.concatenate([img, np.full((*img.shape[:2], 1), 0xFF, np.uint8)], axis=-1)


@contextlib.contextmanager
def sync_debug(mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` while the block runs."""
    import torch

    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def counted_syncs(fn):
    """(``fn()``, the host syncs it made: sync debug warnings, counted)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with sync_debug("warn"):
            out = fn()
    return out, sum("synchronizing" in str(w.message) for w in caught)


def fixed_grid_stats(img, cfg, device) -> tuple:
    """(psnr, bpp) of ``encode_image`` on ``img``: its PSNR, and the exact
    bpp of its factor bits and every block's header by the corpus's float32
    formula (limg_tpu/parallel/mesh.py:113-116)."""
    import limg_tpu_torch
    from limg_tpu_torch.config import static_block_bits

    out = limg_tpu_torch.encode_image(img, cfg, seed=0, device=device)
    h, w = img.shape[:2]
    bits = round(out["avg_block_bits"] * h * w)
    nb = -(-h // 8) * -(-w // 8)
    total = np.float32(bits + static_block_bits(cfg.channels) * nb)
    return out["psnr"], total * (np.float32(1) / np.float32(h * w))


def check_corpus_stats(name: str, got: dict, want: list, idx=None):
    """Per-image corpus stats against the direct encodes': bpp equal, PSNR
    within PSNR_DB_EXACT."""
    idx = range(len(want)) if idx is None else idx
    d_psnr = max(abs(float(got["psnr"][i]) - want[j][0]) for j, i in enumerate(idx))
    bpp_equal = all(np.float32(got["bpp"][i]) == want[j][1] for j, i in enumerate(idx))
    log(f"  {name}: {len(want)} images, max PSNR diff {d_psnr!r} dB, bpp "
        f"{'equal' if bpp_equal else 'NOT equal'}")
    if d_psnr > PSNR_DB_EXACT or not bpp_equal:
        raise AssertionError(f"{name}: per-image stats differ from encode_image's")


def phase_main_path_corpus(device, tmp: str):
    """limg_tpu_torch.parallel on the card: the mesh, the fixed-grid corpus
    (one launch, no host sync), shard bodies on one card, the block-sharded
    4K image, the merged corpus, the multichip gate, the streaming corpus
    and the mixed-size corpus; every kernel's launches counted from 0 over
    the entry points' calls. TGA files go to ``tmp``."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig, native
    from limg_tpu_torch.kernels import launch
    from limg_tpu_torch.ops.dither import image_seed
    from limg_tpu_torch.parallel import corpus, mesh
    from limg_tpu_torch.regions import encode_image_merged_fused_device
    from tools.record_torch_reference import case_images

    log("== phase 3h: corpus and multi-device encode (limg_tpu_torch.parallel)")
    if not native.available():
        raise AssertionError(f"the native runtime did not build: {native.build_log}")
    h, w = CORPUS_HW
    images = corpus_images(STREAM_N)
    paths = [os.path.join(tmp, f"corpus{i:02d}.tga") for i in range(STREAM_N)]
    for path, img in zip(paths, images):
        native.write_tga(path, opaque(img))
    mixed = [opaque(im) for im in corpus_images(3, MIXED_HW, first=100)]
    img4k = case_images(2160, 3840)["rgb"]
    nodither = EncodeConfig(error_factor=100, dithering=False)
    dither = EncodeConfig(error_factor=100)

    # the direct encodes each path is held against (not counted)
    want = [fixed_grid_stats(img, nodither, device) for img in images]
    want_mixed = [fixed_grid_stats(img, nodither, device) for img in mixed]
    want_merged = []
    for i, img in enumerate(images[:CORPUS_N]):
        out = encode_image_merged_fused_device(img, dither, image_seed(0, i), MERGED_LEVELS,
                                               emit_planes=False, device=device)
        want_merged.append((mesh._psnr(out["total_err"], h * w, 3).item(),
                            out["mean_bpp"].to(torch.float32).item()))
    want_4k = limg_tpu_torch.encode_image(img4k, dither, seed=0, device=device)["decoded"][..., :3]
    batch = images[:CORPUS_N]
    batch_d = torch.from_numpy(batch).to(device)
    img4k_d = torch.from_numpy(img4k).to(device)
    torch.cuda.synchronize(device)

    launch.reset_launches()
    # 1. the mesh: one entry per card, never more than there are
    mesh1 = mesh.make_mesh(1, device=device.type)
    if mesh1 != (device,):
        raise AssertionError(f"make_mesh(1) gave {mesh1}")
    try:
        mesh.make_mesh(torch.cuda.device_count() + 1, device="cuda")
        raise AssertionError("make_mesh past the card count did not raise")
    except RuntimeError as e:
        log(f"  make_mesh(1) = {mesh1}; make_mesh({torch.cuda.device_count() + 1}) raised: {e}")
    # 2. the fixed-grid corpus: one launch for the shard, no host sync
    before = launch.launches["encode_fixed_p64"]
    out = mesh.encode_corpus_sharded(batch, nodither, n_devices=1, device=device)
    if launch.launches["encode_fixed_p64"] != before + 1:
        raise AssertionError(f"{CORPUS_N}-image shard: "
                             f"{launch.launches['encode_fixed_p64'] - before} launches, not 1")
    check_corpus_stats(f"fixed-grid corpus ({CORPUS_N} x 1080p, 1 launch)", out,
                       want[:CORPUS_N])
    with sync_debug("error"):
        stats = mesh._corpus_sharded(batch_d, nodither, mesh1, 0)
    again = mesh._fetch(*stats)
    for key in ("psnr", "bpp", "mean_psnr"):
        if not np.array_equal(again[key], out[key]):
            raise AssertionError(f"device-resident corpus: {key} differs")
    log("  the device-resident corpus ran under set_sync_debug_mode('error') up to its "
        "fetch: no host sync")
    # 3. eight shard bodies on one card, the same batch split 8 ways
    before = launch.launches["encode_fixed_p64"]
    split = mesh._fetch(*mesh._corpus_sharded(batch_d, nodither, (device,) * CORPUS_N, 0))
    for key in ("psnr", "bpp"):
        if not np.array_equal(split[key], out[key]):
            raise AssertionError(f"8 shard bodies on one card: {key} differs from one shard")
    log(f"  {CORPUS_N} shard bodies on {device} "
        f"({launch.launches['encode_fixed_p64'] - before} launches): per-image "
        f"stats equal the one-shard run's; mean {split['mean_psnr']!r} vs {out['mean_psnr']!r}")
    # 4. the block-sharded 4K image: one shard is encode_image, dithering on
    dec, psnr, bpp = mesh.encode_image_blocks_sharded(img4k, dither, n_devices=1, device=device)
    with sync_debug("error"):
        stats = mesh._blocks_sharded(img4k_d, dither, mesh1, 0)
    again = mesh._blocks_fetch(*stats, dither)
    if not (np.array_equal(again[0], dec) and again[1:] == (psnr, bpp)):
        raise AssertionError("device-resident block-sharded image differs")
    if not np.array_equal(dec, want_4k):
        raise AssertionError("block-sharded 4K image: decode differs from encode_image's")
    log(f"  block-sharded 4K RGB (dithering on, 1 shard): decode equal to encode_image's bit "
        f"for bit; psnr {psnr!r} bpp {bpp!r}; ran under set_sync_debug_mode('error')")
    # 5. the merged corpus, fused, dithering on: each image its own encode
    merged, syncs = counted_syncs(lambda: mesh.encode_corpus_sharded_merged(
        batch, dither, n_devices=1, num_levels=MERGED_LEVELS, device=device))
    _, syncs_one = counted_syncs(lambda: encode_image_merged_fused_device(
        batch_d[0], dither, image_seed(0, 0), MERGED_LEVELS, emit_planes=False, device=device))
    for i, (p, b) in enumerate(want_merged):
        if merged["psnr"][i] != np.float32(p) or merged["bpp"][i] != np.float32(b):
            raise AssertionError(f"merged corpus image {i}: ({merged['psnr'][i]}, "
                                 f"{merged['bpp'][i]}) vs its own encode ({p}, {b})")
    log(f"  merged corpus ({CORPUS_N} x 1080p, fused, {MERGED_LEVELS} levels, dithering on): "
        f"each image bit-equal to encode_image_merged_fused_device(image_seed(0, i)); mean "
        f"psnr {merged['mean_psnr']!r}, mean bpp {float(merged['bpp'].mean())!r}; host syncs "
        f"{syncs} for the corpus with its fetch, {syncs_one} per image encode")
    # 6. the multichip gate at one card
    multichip_gate(1, device)
    # 7. the streaming corpus on the native pool
    stream = corpus.encode_corpus_streaming(paths, h, w, nodither, device=device)
    if stream["failed"]:
        raise AssertionError(f"streaming: files failed {stream['failed']}")
    check_corpus_stats(f"streaming corpus ({STREAM_N} TGA files of 1080p)", stream, want)
    holed = corpus.encode_corpus_streaming(paths[:3] + [os.path.join(tmp, "missing.tga")]
                                           + paths[3:4], h, w, nodither, device=device)
    if holed["failed"] != [3]:
        raise AssertionError(f"streaming with a missing file: failed {holed['failed']}, not [3]")
    check_corpus_stats("streaming with a missing file", holed, want[:4], idx=[0, 1, 2, 4])
    log("  streaming: a missing file lands in failed ([3])")
    # 8. the mixed-size corpus: 5 x 1080p and 3 x 720p, some as TGA paths
    items = [paths[0], opaque(images[1]), mixed[0], opaque(images[2]), paths[3], mixed[1],
             opaque(images[4]), mixed[2]]
    mix = mesh.encode_corpus_sharded_mixed(items, nodither, n_devices=1, device=device)
    log(f"  mixed corpus buckets {mix['buckets']}")
    check_corpus_stats("mixed corpus, 1080p bucket", mix, [want[i] for i in (0, 1, 2, 3, 4)],
                       idx=[0, 1, 3, 4, 6])
    check_corpus_stats("mixed corpus, 720p bucket", mix, want_mixed, idx=[2, 5, 7])
    log(f"phase 3h ok: kernel launches over the corpus calls {dict(launch.launches)}")


def fixed_planes_words(h: int, w: int, ch: int, device, seed: int = 0):
    """Seeded block-major q and dec words ((NB, 64) int32) of an h x w
    image's grid, and the grid; dec's alpha byte 0xFF for RGB, as the
    block encode writes it."""
    import torch
    from limg_tpu_torch.ops import layout

    grid = layout.grid_for(h, w)
    gen = torch.Generator(device=device).manual_seed(seed)
    q, dec = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, grid.num_blocks, 64), dtype=torch.int32,
                           device=device, generator=gen)
    if ch == 3:
        dec |= -0x1000000
    return q, dec, grid


def main():
    sys.path.insert(0, ROOT)
    import torch

    smi = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    kernels = HeldKernels()
    for phase in (phase_main_path, phase_main_path_merged, phase_main_path_coalesce,
                  phase_main_path_rd, phase_main_path_natural,
                  lambda device: phase_ltp1(device, smi), phase_main_path_dense,
                  phase_main_path_levels, phase_main_path_scatter):
        with kernels.held():
            phase(device)
    with kernels.held(), tempfile.TemporaryDirectory() as tmp:   # the corpus's TGA files
        phase_main_path_corpus(device, tmp)
    log(json.dumps({"kernels": kernels.report()}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
