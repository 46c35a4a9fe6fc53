"""On-card smoke run of limg_tpu_torch: build, check and time the CUDA
kernels, and drive the fixed-grid encode (``limg_tpu_torch.encode_image``),
the quadtree-merged encode without coalescing
(``encode_image_merged(..., coalesce=False)``), the default merged encode
with run coalescing (``encode_image_merged()``, and the CLI's merged mode),
the RD merge policy (``encode_image_merged(merge_policy="rd")``, and the
CLI's ``--rd-merge``), the natural-layout default encode
(``encode_image_merged(fused_layout="natural", return_state=True)``) and
the composed coalesce pass (``coalesce_segments(use_kernel=False)``) and
the dense path (``encode_image_merged(fused=False)``, 1, 3 and 4 levels,
and ``encode_image_merged(num_levels=5 | 6)``, which only it runs) on 4K
images through them, write, read and diagnose LTP1 streams of the
default encode (``bitstream``, ``utils.diagnostics``, the CLI's
``--write-ltp1`` / ``--decode-ltp1`` / ``--diagnose``, and ``--fixed-grid
--write-ltp1``), run the legacy encoder (``encode_legacy``), and encode
corpora of 1080p images over a one-card mesh (``limg_tpu_torch.parallel``:
the fixed-grid, merged and mixed-size corpora, the block-sharded image, the
streaming corpus on the native staging pool), and run the scatter-form
segment refit and crush (``ops.segments.fit_segments`` /
``find_shifts_segments`` with ``contiguous=False``) on 4K segment maps.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports neither JAX nor PIL. Phases:

0. environment: torch, CUDA, nvcc, Triton, the card's name and power limit;
1. build the kernel libraries from limg_tpu_torch/csrc/, one nvcc per
   source, all started together;
2. ``encode_fixed_p64`` vs its plain PyTorch version on the card (same
   inputs): integer outputs bit-equal, dist within 1e-6 relative, over
   images, channel counts, crush modes, num_factors and dithering, and at
   its edges (a last CTA of fewer blocks than the others, all-masked
   blocks);
2b. the same for ``fit_levels`` and ``owner_crush`` over levels 2 to 4,
   RGB and RGBA, aligned and edge-padded images (4-level squares cut by
   both edges), and the same settings; and ``owner_crush`` at ragged
   squares owned at levels 2 and 3 (images whose sides are not multiples
   of 32 or 64 px, with a flat corner), q emitted and not, dithering off
   and on;
2c. the same for the four run-coalescing kernels (``match_pairs``,
   ``match_neighbors``, ``seg_mixed_all``, ``segment_encode``) on seeded and
   fitted rows (``match_neighbors`` also on planes of 1, 2, odd and
   non-multiple-of-32 blocks a side, ``match_pairs`` on 1-129 pairs around
   a warp and a CTA, 3,000 and 16,132), random and real segment maps (the
   batched scan, ``seg_scan``, on seeded batches of 1 to 129,600 lanes
   around its 2,048-lane tiles, int and float rows of sum, max and min,
   column problems, more problems than one launch takes, and every scan
   call of a 4K default and RD encode), segment_encode's edges
   (segments of 1, 31, 32, 33 and 256 members across its tiles, a tail of
   lanes with no member, no member at all), RGB and RGBA, every crush
   mode, num_factors 1-3, dithering off and on;
2d. the same for ``encode_region`` at P = 256, 1024 and 4096 (16x16, 32x32
   and 64x64 pixel regions), RGB and RGBA, aligned and edge-padded images,
   the settings of phase 2, and at its edges (part-filled last CTAs,
   all-masked regions);
2e. the same for ``fit_levels_natural`` and ``owner_crush_natural`` (levels
   2 to 4, RGB and RGBA, edge-padded images, the settings of phase 2, q
   emitted and not; the crush also at phase 2b's ragged squares), for
   ``crush_eval_rows`` (per-block triples at K = 1, 8, 27 and 729; the
   search's stride-0 tables: the 27 axis sweeps, an exhaustive chunk, the
   guess triples, the floors' K = 1; a table with duplicates, K = 19, and
   one of 200 rows; ragged N with an all-masked block, RGB and RGBA, P = 64
   and 256) and for the composed segment re-encode against the segment
   kernel on real run buffers;
2f. the same for ``segment_encode`` at P = 256, 1024 and 4096 (the dense
   path's 16x16, 32x32 and 64x64 pixel regions; a thread-block cluster a
   segment): seeded buffers, segments of 1 and SEG_CAP regions (at P =
   4096 a warp streams its share through its stage), a tail of lanes with
   no member, no member at all, every lane a member and a segment (the
   most segments listed), a saturated 64x64 region whose unscaled error
   sum passes 2^31; RGB and RGBA, every crush mode, num_factors 1-3,
   dithering off and on;
2g. the same for the region encode and the segment encode at P = 16,384,
   65,536 and 262,144 (the dense path's 128x128, 256x256 and 512x512 px
   regions: the region encode's clusters of 1, 4 and 16 CTAs, the
   segment encode's 16-CTA clusters): seeded buffers with all- and
   half-masked regions and a saturated region whose pre-scaled error sum
   wraps int32, a ragged image's grid and that grid with an all-masked
   row and column, a buffer of one region at P = 65,536 (one cluster),
   segments of one and several regions with an empty tail, no member at
   all, single-region segments whose every pixel is a member (a region
   over every warp of a cluster); RGB and RGBA, ladder, exhaustive, guess
   and no crush, num_factors 1-3, dithering off and on; and both encodes
   at level 9 (P = 16,777,216: the segment encode's regions take several
   rounds of a cluster's warps, the region encode's CTAs read their shares
   from device memory pass by pass): a saturated single-region segment and
   one of two regions, ladder, guess and no crush;
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
   it (the sums its atomics change); the ladder call, the fit and
   ``seg_sum_fold`` timed by CUDA events;
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
   0 over these calls;
4. / 4b. / 4c. / 4d. / 4e. / 4f. kernel and plain times at the 4K shapes of each
   path (each compared once more), and each path's device-resident step,
   CUDA events, median of 10 runs after warm-up, with a torch.profiler
   breakdown (the fit, owner-crush and segment kernels' device time in the
   step beside their events time alone) and each kernel's launches per
   default and RD step; 4e also times the natural pair against the Morton
   pair, the natural step against the Morton step, both
   ``crush_eval_rows`` calls of the composed coalesce pass (the sweep
   table and the verified per-block triples) with their bounds, and the
   composed pass against the segment kernel's; 4f times ``segment_encode``
   at the dense levels' 4K buffers (P = 256, 1024, 4096) and the dense
   3-level step; 4h the region encode at the 4K image's level-4, level-5
   and level-6 regions, the segment encode on a 6-level encode's level-4
   and level-5 buffers, and the dense 5-level step (4K RGB);
4g. the 8 x 1080p fixed-grid corpus (one launch) against 8
   ``encode_perf_step`` calls, its device memory and device time per
   image, its kernel on the shard against its plain version and bound, the
   8 x 1080p merged corpus, and four host walls of the 32-file streaming
   corpus: staging alone, encode alone, ``encode_corpus_streaming``, and the
   same loop with the JAX package's ``await_all`` wait;
4i. the fixed grid's epilogue, ``fixed_planes``, on seeded words of phase
   3's 4K grid (tiles that cross block rows), a ragged 750 x 997 grid
   (edge blocks cut, a tail tile) and an 8192 x 5464 grid (the benchmark's
   photos), RGB and RGBA, bit-equal in values and strides to the
   composition it replaces; at 8192 x 5464 timed beside it: the two
   ``torch.stack`` calls of ``unpack_plane`` and ``assemble_decoded``, each
   alone, and the kernel's bandwidth against the bound (its bytes over
   3.35 TB/s).

Prints the order in which to redesign the kernels (the ms each loses above
its bound per default step, then per RD step: its profiler device time in
the step less the bounds of its launches there), one JSON line of kernel
results (each with its launches on its path's main run, its time, its
plain version's, and its bound: the least time the card could take for
the call's bytes and operations), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
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
REGION_SOURCE = "limg_tpu_torch/csrc/encode_region.cu"
SEGMENT_REGION_SOURCE = "limg_tpu_torch/csrc/segment_region.cu"
NATURAL_SOURCE = "limg_tpu_torch/csrc/encode_natural.cu"
NATURAL_REPLACES = {
    "fit_levels_natural": "limg_tpu/pallas_kernels/encode_natural.py:421",
    "owner_crush_natural": "limg_tpu/pallas_kernels/encode_natural.py:528",
}
CRUSH_EVAL_SOURCE = "limg_tpu_torch/csrc/crush_eval.cu"
# crush_eval_rows_k_pallas; crush_eval_rows_pallas (:1021) is its K = 1 form
CRUSH_EVAL_REPLACES = "limg_tpu/pallas_kernels/encode_fixed.py:1063"
# no Pallas kernel: the scatter-add of the JAX package's seg_sum, which the
# card folds in block order
SEG_FOLD_SOURCE = "limg_tpu_torch/csrc/seg_fold.cu"
SEG_FOLD_REPLACES = "limg_tpu/ops/segments.py:44"
# no Pallas kernel: the fixed-grid encode's unpacking of the kernel's words
# into its planes and decoded image, which the JAX package does in jnp
FIXED_PLANES_SOURCE = "limg_tpu_torch/csrc/fixed_planes.cu"
FIXED_PLANES_REPLACES = "limg_tpu/encoder.py:132-133, :104 (jnp)"
# the fixed-grid epilogue's timed grid: the benchmark's 8192 x 5464 photos;
# and a ragged one: 94 blocks a row, 125 rows, cut at both edges, 183 tiles and 38
FIXED_PLANES_SIZE = (5464, 8192)
FIXED_PLANES_RAGGED = (997, 750)
# P = 256 / 1024 run encode_blocks_pallas's mono kernel (:739), P = 4096
# its fit and crush kernels (:764, :781)
REGION_SIZES = (256, 1024, 4096)
RD_LAMBDA = 0.01
# the RD path's kernels
RD_KERNELS = ("encode_fixed_p64", "encode_region_p256", "encode_region_p1024",
              "encode_region_p4096", "match_neighbors", "match_pairs", "seg_mixed_all",
              "segment_encode")
# the segment encode's region sizes on the dense path's levels 1-3, and the
# dense path's kernels (at 1-4 levels)
SEGMENT_SIZES = (256, 1024, 4096)
DENSE_KERNELS = RD_KERNELS + tuple(f"segment_encode_p{p}" for p in SEGMENT_SIZES)
# the dense path's levels 4 and 5 at 4K (128x128 and 256x256 px regions, P =
# 16,384 and 65,536): the region and segment encodes of a 6-level encode
LEVEL_SIZES = (16384, 65536)
LEVELS_KERNELS = DENSE_KERNELS + tuple(f"{k}_p{p}" for k in ("encode_region", "segment_encode")
                                       for p in LEVEL_SIZES)
# phase 4h times the region encode also at level 6 (512x512 px, P = 262,144:
# 40 regions at 4K), which no encode of phase 3i reaches
TIMED_REGION_SIZES = LEVEL_SIZES + (262144,)
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
TIMED_RUNS = 10
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


SETTINGS = ([(mode, 3, dith) for mode in ("ladder", "exhaustive", "guess", "none")
             for dith in (False, True)]
            + [("ladder", nf, dith) for nf in (1, 2) for dith in (False, True)]
            + [("exhaustive", 1, False), ("guess", 2, True)])


# the region encode at its edges: a last CTA that holds fewer regions than
# the others (32 blocks a CTA at P = 64, 8 regions at 256, 2 at 1024; 96 x
# 160 px is 240 blocks, 60 / 15 / 6 regions) and regions with no pixel
# inside the image (a grid one region row and column larger than the image)
EDGE_IMAGE = (96, 160)
# the segment encode's ladder at K = 1 and MAX_LADDER_K, and at error factor
# 10 (small shifts: verified candidates that are sweeps, whose values the
# kernel takes from its sweep pass)
SEGMENT_LADDER_ENDS = ((1, 100), (16, 100), (8, 10))
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


def compare_region_edges(device, sizes, settings=EDGE_SETTINGS) -> tuple:
    """encode_fixed_p64 / encode_region vs the plain version on
    region_edge_buffers of the EDGE_IMAGE, RGB and RGBA; (max abs diff,
    cases)."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.regions import _words
    from tools.make_test_image import make_4k

    worst, n_cases = 0.0, 0
    rgb = make_4k(*EDGE_IMAGE)
    for ch in (3, 4):
        words = _words(_as_image_tensor(rgb if ch == 3 else with_alpha(rgb), device))
        for p in sizes:
            for buf, (packed, mask) in region_edge_buffers(words, p).items():
                for mode, nf, dith in settings:
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    got = kmod.encode_blocks_kernel(packed, mask, cfg, 7, emit_endpoints=True)
                    want = kmod.encode_blocks_reference(packed, mask, cfg, 7, emit_endpoints=True)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    try:
                        worst = max(worst, compare_outputs(got, want))
                    except AssertionError as e:
                        raise AssertionError(f"edge {buf} ch={ch} P={p} {mode} nf={nf} "
                                             f"dither={dith}: {e}")
                    n_cases += 1
    return worst, n_cases


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
    edge, n_edge = compare_region_edges(device, (64,))
    worst, n_cases = max(worst, edge), n_cases + n_edge
    log(f"  a part-filled last CTA and all-masked blocks: {n_edge} cases bit-equal")
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
                  "301x437": make_4k(301, 437), "37x200": make_4k(37, 200)}
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
    ragged, n_ragged = compare_ragged_crush(device, km.fit_levels_reference,
                                            km.owner_crush_kernel, km.owner_crush_reference)
    worst, n_cases = max(worst, ragged), n_cases + n_ragged
    log(f"  owner_crush at ragged squares: {n_ragged} cases bit-equal")
    log(f"phase 2b ok: {n_cases} cases, max abs diff {worst}")
    return worst


def phase_compare_region(device, images=None) -> float:
    """encode_region vs its plain version at P = 256, 1024 and 4096; max
    abs diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.regions import _words
    from tools.make_test_image import make_4k

    log("== phase 2d: region encode kernel vs plain version on the card")
    if images is None:
        images = {"256x384": make_4k(256, 384), "301x437": make_4k(301, 437)}
    worst, n_cases = 0.0, 0
    for name, rgb in images.items():
        for ch in (3, 4):
            words = _words(_as_image_tensor(rgb if ch == 3 else with_alpha(rgb), device))
            for p in REGION_SIZES:
                packed, mask, _ = layout.blockify_words(words, int(p ** 0.5))
                for mode, nf, dith in SETTINGS:
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    got = kmod.encode_blocks_kernel(packed, mask, cfg, 7, emit_endpoints=True)
                    want = kmod.encode_blocks_reference(packed, mask, cfg, 7, emit_endpoints=True)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    try:
                        worst = max(worst, compare_outputs(got, want))
                    except AssertionError as e:
                        raise AssertionError(f"{name} ch={ch} P={p} {mode} nf={nf} "
                                             f"dither={dith}: {e}")
                    n_cases += 1
        log(f"  {name}: {2 * 3 * len(SETTINGS)} cases bit-equal")
    edge, n_edge = compare_region_edges(device, REGION_SIZES)
    worst, n_cases = max(worst, edge), n_cases + n_edge
    log(f"  part-filled last CTAs and all-masked regions: {n_edge} cases bit-equal")
    log(f"phase 2d ok: {n_cases} cases, max abs diff {worst}")
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


# match_pairs: one pair, a part-filled warp, one warp, the next; the same
# around a 128-thread CTA; many CTAs; level 2's neighbour pairs at 4K
MATCH_PAIRS_SIZES = (1, 31, 32, 33, 127, 128, 129, 3000, 16132)
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


COALESCE_SETTINGS_SEEDED = [("ladder", 3, False), ("ladder", 3, True), ("exhaustive", 1, False),
                            ("guess", 2, True), ("none", 3, False), ("ladder", 2, True)]


def phase_compare_coalesce(device, images=None) -> float:
    """The four run-coalescing kernels vs their plain versions; max abs diff."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.kernels import coalesce as kc
    from tools.make_test_image import make_4k
    from tools.record_torch_reference import case_images

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

    # match kernels on seeded rows (one thread a pair: part-filled warps and
    # CTAs, and level 2's 16,132 pairs at 4K)
    for ch in (3, 4):
        for n in MATCH_PAIRS_SIZES:
            a = torch.from_numpy(seeded_rows(rng, n, ch)).to(device)
            b = a + (torch.rand(a.shape, device=device) < 0.3) * torch.randint(
                0, 6, a.shape, device=device)
            check(f"match_pairs seeded ch={ch} n={n}", [kc.match_pairs_kernel(a, b, ch)],
                  [kc.match_pairs_reference(a, b, ch)])
        for by, bx in ((37, 150), (1, 70), (40, 1), (130, 130)):
            plane = torch.from_numpy(seeded_rows(rng, by * bx, ch)).to(device).reshape(-1, by, bx)
            check(f"match_neighbors seeded ch={ch} {by}x{bx}",
                  kc.match_neighbors_kernel(plane, ch), kc.match_neighbors_reference(plane, ch))
        for by, bx in NEIGHBOR_EDGES:
            plane = torch.from_numpy(seeded_rows(rng, by * bx, ch)).to(device).reshape(-1, by, bx)
            check(f"match_neighbors at its edges ch={ch} {by}x{bx}",
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
    # the batched scan: seeded batches of every size around its 2,048-lane
    # tiles, int and float rows of sum, max and min, column problems, and
    # the scans of the 4K default and RD steps
    for seed in range(3):
        for name, batch in scan_batches(np.random.default_rng(seed), device).items():
            check(f"seg_scan {name} seed={seed}", kc.seg_scan(batch), kc.seg_scan_reference(batch))
    for lane, img in case_images(2160, 3840).items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba", dithering=False)
        for policy in ("match", "rd"):
            calls = capture_coalesce_calls(lambda: limg_tpu_torch.encode_image_merged(
                img, cfg, merge_policy=policy, rd_lambda=RD_LAMBDA, fetch_planes=False,
                device=device))["seg_scan"]
            for i, (args, kwargs) in enumerate(calls):
                check(f"seg_scan 4K {lane} {policy} call {i}", kc.seg_scan(*args, **kwargs),
                      kc.seg_scan_reference(*args, **kwargs))
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
            for k, ef in SEGMENT_LADDER_ENDS:
                cfg = EncodeConfig(error_factor=ef, has_alpha=ch == 4, ladder_k=k)
                check(f"segment_encode seeded ch={ch} n={n} ladder K={k} error_factor={ef}",
                      kc.segment_encode_kernel(*buf, cfg, 0x5EED),
                      kc.segment_encode_reference(*buf, cfg, 0x5EED))
    # segment encode at its edges: 1-256 members, tile crossings, empty lanes
    for ch in (3, 4):
        for name, buf in edge_run_buffers(rng, ch, device).items():
            for mode, nf, dith in COALESCE_SETTINGS_SEEDED:
                cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                   dithering=dith, num_factors=nf)
                check(f"segment_encode {name} ch={ch} {mode} nf={nf} dither={dith}",
                      kc.segment_encode_kernel(*buf, cfg, 0x5EED),
                      kc.segment_encode_reference(*buf, cfg, 0x5EED))
    log(f"  seeded and edge buffers: {n_cases} cases bit-equal")
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


def phase_compare_natural(device, images=None) -> float:
    """fit_levels_natural / owner_crush_natural and crush_eval_rows vs their
    plain versions, and the composed segment re-encode vs the segment
    kernel; max abs diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import crush_eval as kce
    from limg_tpu_torch.kernels import encode_natural as kn
    from limg_tpu_torch.ops.crush import _const_cands
    from limg_tpu_torch.regions import _words
    from tools.make_test_image import make_4k
    from tools.record_torch_natural_reference import crush_eval_inputs

    log("== phase 2e: natural-layout kernels and crush_eval_rows vs plain versions on the card")
    if images is None:
        images = {"70x90": small_image(70, 90), "301x437": make_4k(301, 437)}
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

    for name, rgb in images.items():
        for ch in (3, 4):
            words = _words(_as_image_tensor(rgb if ch == 3 else with_alpha(rgb), device))
            for levels in (2, 3, 4):
                for i, (mode, nf, dith) in enumerate(SETTINGS):
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    emit_q = (i // 2) % 2 == 0
                    case = (f"{name} ch={ch} levels={levels} {mode} nf={nf} dither={dith} "
                            f"emit_q={emit_q}")
                    fit = kn.fit_levels_natural_reference(words, cfg, levels)
                    check(f"{case} fit", kn.fit_levels_natural_kernel(words, cfg, levels), fit)
                    args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, levels, 7, emit_q)
                    check(f"{case} crush", kn.owner_crush_natural_kernel(*args),
                          kn.owner_crush_natural_reference(*args))
        log(f"  {name}: {2 * 3 * len(SETTINGS)} cases bit-equal (natural fit and crush)")
    ragged, n_ragged = compare_ragged_crush(device, kn.fit_levels_natural_reference,
                                            kn.owner_crush_natural_kernel,
                                            kn.owner_crush_natural_reference)
    worst, n_cases = max(worst, ragged), n_cases + n_ragged
    log(f"  owner_crush_natural at ragged squares: {n_ragged} cases bit-equal")
    # crush_eval_rows: per-block triples at every K the search asks for and
    # the exhaustive 729, and the search's stride-0 tables (crush_eval_tables),
    # ragged N up to the full 4K buffer with an all-masked block, both block
    # sizes
    n_ce = n_cases
    for ch in (3, 4):
        for p in (64, 256):
            for n, k in ((1, 1), (37, 8), (1000, 27), (3001, 729), (129600, 27)):
                packed, mask, f8p, eps, cands = crush_eval_inputs(ch, n=n, k=k, seed=p + n)
                if p == 256:
                    packed, mask, f8p = (np.concatenate([a] * 4) for a in (packed, mask, f8p))
                mask = mask.copy()
                mask[:, n // 2] = 0
                ins = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in (packed, mask, f8p, eps)]
                per_block = torch.from_numpy(cands).to(device)
                check(f"crush_eval_rows ch={ch} P={p} N={n} per-block K={k}",
                      kce.crush_eval_rows_kernel(*ins, per_block, ch),
                      kce.crush_eval_rows_reference(*ins, per_block, ch))
                for name, triples in crush_eval_tables(n).items():
                    table = _const_cands(triples, n, device)
                    check(f"crush_eval_rows ch={ch} P={p} N={n} {name}",
                          kce.crush_eval_rows_kernel(*ins, table, ch),
                          kce.crush_eval_rows_reference(*ins, table, ch))
    log(f"  crush_eval_rows: {n_cases - n_ce} cases bit-equal")
    # the composed re-encode (seg_mixed_all_kernel + crush_eval_rows_kernel)
    # against the segment kernel on real run buffers
    rgb = make_4k(256, 384)
    for ch in (3, 4):
        img = rgb if ch == 3 else with_alpha(rgb)
        buf, _ = image_run_buffer(img, EncodeConfig(error_factor=100, has_alpha=ch == 4,
                                                    dithering=False), device)
        for mode, nf, dith in COALESCE_SETTINGS_SEEDED:
            cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                               dithering=dith, num_factors=nf)
            check(f"256x384 ch={ch} composed segment encode {mode} nf={nf} dither={dith}",
                  kc.segment_encode_composed(*buf, cfg, 0x5EED),
                  kc.segment_encode_kernel(*buf, cfg, 0x5EED))
    log(f"phase 2e ok: {n_cases} cases, max abs diff {worst}")
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
    from limg_tpu_torch.kernels import fixed_planes as kfp
    from tools.record_torch_reference import case_images

    log("== phase 3: fixed-grid path (limg_tpu_torch.encode_image)")
    with open(FIXTURE) as f:
        cases = json.load(f)["cases"]
    h, w = cases[f"{size}_rgb_nodither"]["height"], cases[f"{size}_rgb_nodither"]["width"]
    images = case_images(h, w)
    kmod.launches = kfp.launches = 0
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
    if kfp.launches != n_encodes + 1:
        raise AssertionError(f"{kfp.launches} fixed_planes launches for {n_encodes + 1} encodes")
    log(f"phase 3 ok: {n_encodes + 1} encodes, {launched} kernel launches and {kfp.launches} "
        f"of fixed_planes, outputs on {decoded.device}")
    return launched, kfp.launches


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


def reset_launches():
    """Every kernel's launch count to 0."""
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import crush_eval as kce
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn
    from limg_tpu_torch.kernels import seg_fold as ksf

    for counts in (km.launches, kc.launches, kmod.launches_region, kn.launches, kce.launches,
                   ksf.launches):
        for k in counts:
            counts[k] = 0
    kmod.launches = 0


def read_launches() -> dict:
    """Every kernel's launch count, by kernel name."""
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import crush_eval as kce
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn
    from limg_tpu_torch.kernels import seg_fold as ksf

    return {**km.launches, **kc.launches, **kn.launches, **kce.launches, **ksf.launches,
            "encode_fixed_p64": kmod.launches,
            **{f"encode_region_p{p}": n for p, n in kmod.launches_region.items()}}


def phase_main_path_coalesce(device):
    """encode_image_merged() with its defaults at 4K through all six
    merged-path kernels, then the CLI's merged mode."""
    import tempfile

    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
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
    launched = {k: v for k, v in read_launches().items()
                if k in (*MERGED_REPLACES, *COALESCE_REPLACES)}
    if min(launched.values()) == 0:
        raise AssertionError(f"the default merged path skipped a kernel: launches {launched}")
    log(f"  {n_encodes} encodes, launches {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "img4k.npy")
        np.save(npy, images["rgb"])
        for ln in run_cli([npy, "--no-output"]):
            log(f"  cli: {ln}")
    log("phase 3c ok")
    return launched


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
    from tools.record_torch_reference import case_images

    log("== phase 3d: RD path (limg_tpu_torch.encode_image_merged(merge_policy='rd'))")
    fx = np.load(RD_FIXTURE)
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    reset_launches()
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
    launched = {k: v for k, v in read_launches().items() if k in RD_KERNELS}
    if min(launched.values()) == 0:
        raise AssertionError(f"the RD path skipped a kernel: launches {launched}")
    log(f"  {n_encodes} encodes, launches {launched}")
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "img4k.npy")
        np.save(npy, images["rgb"])
        for ln in run_cli([npy, "--rd-merge", "--no-output"]):
            log(f"  cli --rd-merge: {ln}")
    log("phase 3d ok")
    return launched


def crush_eval_tables(n: int) -> dict:
    """The shift tables crush_eval_rows is held to at N blocks: the
    search's (the ladder's 27 axis sweeps, an exhaustive chunk of 81, the
    guess mode's 4 triples, the reduced-factor floors' (0, 0, 0)), a seeded
    table of 19 rows with duplicates and shifts above 8, and one of 200 rows
    (two launches; below the full 4K buffer)."""
    from limg_tpu_torch.ops.crush import GUESS_TRIPLES

    rng = np.random.default_rng(n)
    every = [(a, b, c) for a in range(9) for b in range(9) for c in range(9)]
    few = [tuple(int(v) for v in rng.integers(0, 12, 3)) for _ in range(6)]
    tables = {
        "sweep table K=27": [tuple(s if ax == a else 0 for ax in range(3))
                             for a in range(3) for s in range(9)],
        f"exhaustive chunk {n % 9} K=81": every[81 * (n % 9):81 * (n % 9 + 1)],
        "guess table K=4": list(GUESS_TRIPLES),
        "floors table K=1": [(0, 0, 0)],
        "table with duplicates K=19": [few[i] for i in rng.integers(0, 6, 19)],
    }
    if n < 129600:
        tables["table K=200"] = [tuple(int(v) for v in rng.integers(0, 9, 3))
                                 for _ in range(200)]
    return tables


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
    from tools.record_torch_reference import case_images

    log("== phase 3e: natural-layout default path (encode_image_merged(fused_layout='natural', "
        "return_state=True))")
    fx, nfx = np.load(COALESCE_FIXTURE), np.load(NATURAL_FIXTURE)
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    nb = -(-h // 8) * -(-w // 8)
    reset_launches()
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
    launched = {k: v for k, v in read_launches().items()
                if k in (*NATURAL_REPLACES, *MERGED_REPLACES, *COALESCE_REPLACES)}
    if min(launched[k] for k in (*NATURAL_REPLACES, *COALESCE_REPLACES)) == 0 or any(
            launched[k] for k in MERGED_REPLACES):
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
    reset_launches()
    got = composed_pass(state, cfg, 0, False)
    composed = read_launches()
    lv_k, lv_c = want[0], got[0]
    diff = [k for k in lv_k if not torch.equal(lv_k[k], lv_c[k])]
    if (diff or not torch.equal(want[1], got[1]) or int(want[2]) != int(got[2])
            or {k: int(v) for k, v in want[3].items()} != {k: int(v) for k, v in got[3].items()}):
        raise AssertionError(f"the composed coalesce pass differs from the segment kernel's: {diff}")
    if composed["crush_eval_rows"] == 0 or composed["segment_encode"] != 0:
        raise AssertionError(f"the composed pass's launches are off: {composed}")
    launched["crush_eval_rows"] = composed["crush_eval_rows"]
    log(f"  composed coalesce pass on the 4K RGB default state ({int(got[2])} runs): bit-equal to "
        f"the segment kernel's; launches crush_eval_rows {composed['crush_eval_rows']}, "
        f"seg_mixed_all {composed['seg_mixed_all']}, segment_encode {composed['segment_encode']}")
    log("phase 3e ok")
    return launched


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
    reset_launches()
    encodes = {}
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        out, state = limg_tpu_torch.encode_image_merged(img, cfg, return_state=True,
                                                        device=device)
        encodes[lane] = (cfg, out, state)
    launched = {k: v for k, v in read_launches().items()
                if k in (*MERGED_REPLACES, *COALESCE_REPLACES)}
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
# Phase 2f: the segment encode at P = 256 / 1024 / 4096 (the dense path's
# levels 1-3)
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


def phase_compare_segment_regions(device) -> float:
    """segment_encode at P = 256, 1024 and 4096 vs its plain version on the
    card, bit-equal: seeded buffers over several CTAs, RGB and RGBA, every
    crush mode, num_factors 1-3, dithering off and on; at its edges
    (segments of 1 and SEG_CAP regions, a tail of lanes with no member, no
    member at all, a saturated 64x64 region); max abs diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.kernels import coalesce as kc

    log("== phase 2f: segment_encode at P = 256 / 1024 / 4096 vs its plain version on the card")
    rng = np.random.default_rng(2026)
    worst, n_cases = 0.0, 0

    def check(case, buf, cfg):
        nonlocal worst, n_cases
        got = kc.segment_encode_kernel(*buf, cfg, 0x5EED)
        want = kc.segment_encode_reference(*buf, cfg, 0x5EED)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        try:
            worst = max(worst, compare_outputs(got, want))
        except AssertionError as e:
            raise AssertionError(f"{case}: {e}")
        n_cases += 1

    for p in SEGMENT_SIZES:
        for ch in (3, 4):
            n = SEGMENT_LANES[p]
            bufs = {"seeded": region_run_buffer(rng, p, n, ch, device, empty_tail=n // 6,
                                                saturate=p == 4096)}
            spans = [1, 256, 1, 3, 31, 33, 1]
            edge = region_run_buffer(rng, p, sum(spans) + 9, ch, device, spans=spans + [9],
                                     empty_tail=9, saturate=p == 4096)
            bufs["edges (1, SEG_CAP members, empty tail)"] = edge
            bufs["no member"] = (edge[0], torch.zeros_like(edge[1]), *edge[2:])
            bufs["every lane a member, one a segment"] = every_lane_a_member(rng, p, n, ch, device)
            for name, buf in bufs.items():
                for mode, nf, dith in COALESCE_SETTINGS_SEEDED:
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    check(f"segment_encode P={p} {name} ch={ch} {mode} nf={nf} dither={dith}",
                          buf, cfg)
            for k, ef in SEGMENT_LADDER_ENDS:
                cfg = EncodeConfig(error_factor=ef, has_alpha=ch == 4, ladder_k=k)
                check(f"segment_encode P={p} seeded ch={ch} ladder K={k} error_factor={ef}",
                      bufs["seeded"], cfg)
        log(f"  P={p}: {n_cases} cases so far bit-equal")
    log(f"phase 2f ok: {n_cases} cases, max abs diff {worst}")
    return worst


# the dense path's levels 4-6 (128x128, 256x256 and 512x512 px regions):
# the region encode's cluster kernel and the segment encode's <CH, 8> ones
LARGE_SIZES = (16384, 65536, 262144)
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


def phase_compare_large(device) -> float:
    """The region encode (encode_region_p16384 ...) and the segment encode
    (segment_encode_p16384 ...) at P = 16,384, 65,536 and 262,144 vs their
    plain versions on the card, bit-equal: RGB and RGBA, ladder, exhaustive,
    guess and no crush, num_factors 1-3, dithering off and on; on seeded
    buffers (all-masked and half-masked regions, lane 0 a saturated region
    whose block-error sum wraps int32 at P >= 65,536), on a ragged image's
    grid and on that grid with an all-masked row and column; the segment
    encode on segments of one and of several regions with a tail of lanes
    with no member, and with no member at all; the region encode on a
    buffer of one region at P = 65,536 (a single cluster); both encodes at
    P = 16,777,216 (the segment encode's regions over several rounds of
    items, the region encode's shares read from device memory). Max abs
    diff."""
    import torch
    from limg_tpu_torch.config import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.regions import _words
    from tools.make_test_image import make_4k

    log("== phase 2g: region encode and segment encode at P = 16,384 / 65,536 / 262,144 vs "
        "their plain versions on the card")
    t0 = time.perf_counter()
    rng = np.random.default_rng(2027)
    rgb = make_4k(*LARGE_IMAGE)
    worst, n_region, n_segment = 0.0, 0, 0

    def check(case, got, want):
        nonlocal worst
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        try:
            worst = max(worst, compare_outputs(got, want))
        except AssertionError as e:
            raise AssertionError(f"{case}: {e}")

    for p in LARGE_SIZES:
        for ch in (3, 4):
            words = _words(_as_image_tensor(rgb if ch == 3 else with_alpha(rgb), device))
            seeded = region_run_buffer(rng, p, LARGE_REGION_LANES[p], ch, device, saturate=True)
            bufs = {"seeded": seeded[:2], **region_edge_buffers(words, p)}
            if p == 65536:   # the seeded buffer's saturated lane 0 alone
                bufs["one region, one cluster"] = tuple(t[:, :1].contiguous()
                                                        for t in seeded[:2])
            for name, (packed, mask) in bufs.items():
                for mode, nf, dith in LARGE_SETTINGS:
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    check(f"encode_region P={p} {name} ch={ch} {mode} nf={nf} dither={dith}",
                          kmod.encode_blocks_kernel(packed, mask, cfg, 7, emit_endpoints=True),
                          kmod.encode_blocks_reference(packed, mask, cfg, 7,
                                                       emit_endpoints=True))
                    n_region += 1
            spans = LARGE_SEGMENT_SPANS[p]
            seg_buf = region_run_buffer(rng, p, sum(spans), ch, device, spans=spans,
                                        empty_tail=spans[-1], saturate=True)
            seg_bufs = {"segments of 1 and several, empty tail": seg_buf,
                        "no member": (seg_buf[0], torch.zeros_like(seg_buf[1]), *seg_buf[2:]),
                        "single regions, every lane a member": every_lane_a_member(
                            rng, p, len(spans), ch, device)}
            for name, buf in seg_bufs.items():
                for mode, nf, dith in LARGE_SETTINGS:
                    cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                                       dithering=dith, num_factors=nf)
                    check(f"segment_encode P={p} {name} ch={ch} {mode} nf={nf} dither={dith}",
                          kc.segment_encode_kernel(*buf, cfg, 0x5EED),
                          kc.segment_encode_reference(*buf, cfg, 0x5EED))
                    n_segment += 1
        log(f"  P={p}: {n_region} region and {n_segment} segment cases so far bit-equal "
            f"({time.perf_counter() - t0:.1f} s)")
    for ch in (3, 4):
        # a saturated single-region segment (its error sum wraps) and a
        # segment of two regions, each region over several rounds of items;
        # the region encode on the same three regions
        buf = region_run_buffer(rng, ROUNDS_PIXELS, 3, ch, device, spans=[1, 2], saturate=True)
        for mode, nf, dith in ROUNDS_SETTINGS:
            cfg = EncodeConfig(error_factor=100, has_alpha=ch == 4, crush_mode=mode,
                               dithering=dith, num_factors=nf)
            check(f"segment_encode P={ROUNDS_PIXELS} over rounds ch={ch} {mode} nf={nf} "
                  f"dither={dith}", kc.segment_encode_kernel(*buf, cfg, 0x5EED),
                  kc.segment_encode_reference(*buf, cfg, 0x5EED))
            n_segment += 1
            check(f"encode_region P={ROUNDS_PIXELS} ch={ch} {mode} nf={nf} dither={dith}",
                  kmod.encode_blocks_kernel(*buf[:2], cfg, 7, emit_endpoints=True),
                  kmod.encode_blocks_reference(*buf[:2], cfg, 7, emit_endpoints=True))
            n_region += 1
        del buf
    log(f"  P={ROUNDS_PIXELS}: {n_region} region and {n_segment} segment cases so far "
        f"bit-equal ({time.perf_counter() - t0:.1f} s)")
    log(f"phase 2g ok: {n_region} + {n_segment} cases, max abs diff {worst}")
    return worst


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
    from limg_tpu_torch import cli
    from tools import record_torch_dense_reference as drec
    from tools.record_torch_reference import case_images

    log("== phase 3g: dense path (encode_image_merged(fused=False)), --fixed-grid "
        "--write-ltp1, encode_legacy")
    fx, rdfx = np.load(DENSE_FIXTURE), np.load(RD_FIXTURE)
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    reset_launches()
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
    launched = {k: v for k, v in read_launches().items() if k in DENSE_KERNELS}
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
    return launched


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
    from tools import record_torch_dense_reference as drec
    from tools import record_torch_levels_reference as lrec
    from tools.record_torch_reference import case_images

    log("== phase 3i: 5- and 6-level encodes at 4K (the dense path's 128x128 and 256x256 px "
        "regions)")
    fx = np.load(LEVELS_FIXTURE)
    meta = json.loads(str(fx["meta"]))
    images = case_images(2160, 3840)
    h, w = images["rgb"].shape[:2]
    reset_launches()
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
    launched = {k: v for k, v in read_launches().items() if k in LEVELS_KERNELS}
    if min(launched.values()) == 0:
        raise AssertionError(f"the 5- and 6-level encodes skipped a kernel: launches {launched}")
    log(f"  {len(lrec.FULL_CASES)} encodes, launches {launched}")
    log("phase 3i ok")
    return launched


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


def phase_main_path_scatter(device, smi: str):
    """The scatter-form segment refit and crush at 4K RGB and RGBA
    (ops/segments.py ``fit_segments`` / ``find_shifts_segments``, contiguous
    False) on two maps (``scatter_maps``): the fit, the factors on
    ``gather_decomp``, and the search under every crush mode at num_factors
    3 and 2; seg_sum_fold and crush_eval_rows counted from 0; each result
    equal to a second run on the card and to the CPU version (the fit on the
    whole map, the search on ``segment_subset``), empty segments (0, 0, 0)
    and 2^31 - 1; seg_sum_fold held to its plain version; the ladder call and
    the fit timed. Returns (launches, max abs diff, seg_sum_fold's timing
    row)."""
    import torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels.seg_fold import seg_sum_fold_kernel
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.fit import drop_decomposition_axes
    from limg_tpu_torch.ops.segments import (find_shifts_segments, fit_segments, fold_plan,
                                             gather_decomp, seg_sum_plain)
    from limg_tpu_torch.utils.timing import device_busy_ms
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

    reset_launches()
    t0 = time.perf_counter()
    results = {key: run(px, mask, torch.from_numpy(seg).to(device), s, px.shape[0])
               for key, (px, mask, seg, s) in inputs.items()}
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    launched = {k: v for k, v in read_launches().items() if v}
    if not (launched.get("crush_eval_rows") and launched.get("seg_sum_fold")):
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

    # times at the owner map, RGB: the ladder search, the fit, and the fit's
    # seg_sum_fold call on its (3, NB) channel sums
    px, mask, seg, s = inputs[("rgb", "owner")]
    seg_t = torch.from_numpy(seg).to(device)
    out, f8 = results[("rgb", "owner")]
    _, d3, cfg = out[(3, "ladder")]
    ladder = lambda: find_shifts_segments(px, mask, f8, d3, seg_t, s, cfg)
    fit = lambda: fit_segments(px, mask, seg_t, s, 3)
    x = (px.to(torch.float32) * mask).sum(dim=1)
    plan = fold_plan(seg_t, s)
    fold = lambda: seg_sum_fold_kernel(x, seg_t, s, plan)
    ladder_ms, fit_ms = time_fn(ladder, device), time_fn(fit, device)
    busy = [device_busy_ms(fn, 5, device=device) for fn in (ladder, fit, fold)]
    log(f"  4K rgb owner map ({s} segments): find_shifts_segments ladder {ladder_ms!r} ms, "
        f"fit_segments {fit_ms!r} ms (CUDA events, median of {TIMED_RUNS}); device busy per "
        f"call (torch.profiler, 5 calls): ladder {busy[0]!r}, fit {busy[1]!r}, its "
        f"seg_sum_fold call {busy[2]!r} ms [{smi}]")
    out = fold()
    k_ms = time_fn(fold, device)
    p_ms = time_fn(lambda: seg_sum_plain(x, seg_t, s), device)
    zeros, idx = torch.zeros_like(out), seg_t.to(torch.int64)
    lib_ms = time_fn(lambda: zeros.index_add_(1, idx, x), device)
    bound_ms, bound_by = kernel_bound("seg_sum_fold", (x, seg_t, s, plan), out)
    log(f"  4K rgb seg_sum_fold (3, {nb}) -> (3, {s}): kernel {k_ms!r} ms, plain version "
        f"(index_add_ into new zeros) {p_ms!r} ms, index_add_ {lib_ms!r} ms, bound {bound_ms!r} "
        f"ms ({bound_by}) [{smi}]")
    log(f"phase 3j ok: the scatter refit and crush on the card equal the CPU version and a "
        f"second run (max abs diff {max(worst, worst_f)})")
    return launched, max(worst, worst_f), (k_ms, p_ms, bound_ms, bound_by, lib_ms)


# ---------------------------------------------------------------------------
# Bounds: bytes and operations of a call, counted from its inputs and outputs
# (each tensor read or written once) and from the kernels' code
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
        bound = kernel_bound("encode_fixed_p64", (packed, mask, cfg),
                             encode_blocks_kernel(packed, mask, cfg, 0))
        # plain, kernel, kernel, plain: both see the same card state
        p1 = time_fn(lambda: encode_blocks_reference(packed, mask, cfg, 0), device)
        k1 = time_fn(lambda: encode_blocks_kernel(packed, mask, cfg, 0), device)
        k2 = time_fn(lambda: encode_blocks_kernel(packed, mask, cfg, 0), device)
        p2 = time_fn(lambda: encode_blocks_reference(packed, mask, cfg, 0), device)
        step = time_fn(lambda: encode_perf_step(img_d, cfg, 0, device), device)
        mpx = img.shape[0] * img.shape[1] * 1e-6
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        rows[lane] = (k_ms, p_ms, *bound)
        log(f"  4K {lane}: kernel {k1!r} / {k2!r} ms ({mpx / k_ms * 1e3!r} Mpx/s), "
            f"plain {p1!r} / {p2!r} ms ({mpx / p_ms * 1e3!r} Mpx/s), bound {bound[0]!r} ms "
            f"({bound[1]}); "
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
                              lambda: km.fit_levels_reference(words, cfg, lv), (words, cfg, lv)),
               "owner_crush": (lambda: km.owner_crush_kernel(*args),
                               lambda: km.owner_crush_reference(*args), args)}
        mpx = img.shape[0] * img.shape[1] * 1e-6
        for name, (kern, plain, call) in fns.items():
            bound = kernel_bound(name, call, kern())
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
            rows[(name, lane)] = (min(k1, k2), min(p1, p2), *bound)
            log(f"  4K {lane} {name}: kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms, "
                f"bound {bound[0]!r} ms ({bound[1]}) [{smi}]")

        def step():
            out = encode_image_merged_fused_device(img_d, cfg, 0, lv, emit_planes=False,
                                                   coalesce=False, device=device)
            return out["total_err"], out["mean_bpp"]

        step_ms = time_fn(step, device)
        log(f"  4K {lane} merged step (encode_image_merged_fused_device, emit_planes=False): "
            f"{step_ms!r} ms = {mpx / step_ms * 1e3!r} Mpx/s [{smi}]")
        prof = profile_step(step, device, f"{lane} merged")
        for name in fns:
            log_profiled(prof, name, rows[(name, lane)][0], lane, smi)
    log(f"phase 4b ok: 4K merged kernel outputs equal the plain versions' (max abs diff {worst})")
    return rows, worst


def step_bounds(fn) -> dict:
    """Each kernel's bound summed over its launches in one call of the step
    ``fn``, every launch at its own shape: {kernel name: ms}."""
    from limg_tpu_torch import encoder, regions
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn

    wrappers = [(kc, "match_neighbors_kernel"), (kc, "match_pairs_kernel"),
                (kc, "seg_scan"), (kc, "segment_encode_kernel"),
                (km, "fit_levels_kernel"), (km, "owner_crush_kernel"),
                (kn, "fit_levels_natural_kernel"), (kn, "owner_crush_natural_kernel"),
                (kmod, "encode_blocks_kernel")]
    totals, saved = {}, {n: getattr(m, n) for m, n in wrappers}

    def spy(fname):
        def call(*args, **kwargs):
            out = saved[fname](*args, **kwargs)
            name = COALESCE_WRAPPERS.get(fname, fname[:-len("_kernel")])
            if fname == "segment_encode_kernel":
                name = kc.segment_kernel_name(args[0].shape[0])
            if fname == "encode_blocks_kernel":
                p = args[0].shape[0]
                name = "encode_fixed_p64" if p == 64 else f"encode_region_p{p}"
            kind = ("encode_region" if name.startswith("encode_region")
                    else "segment_encode" if name.startswith("segment_encode") else name)
            totals[name] = totals.get(name, 0.0) + kernel_bound(kind, args, out)[0]
            return out
        return call

    users = (regions, encoder)
    try:
        for mod, fname in wrappers:
            setattr(mod, fname, spy(fname))
            for user in users:
                if hasattr(user, fname):
                    setattr(user, fname, getattr(mod, fname))
        fn()
    finally:
        for mod, fname in wrappers:
            setattr(mod, fname, saved[fname])
            for user in users:
                if hasattr(user, fname):
                    setattr(user, fname, saved[fname])
    return totals


def profiled_kernel_name(key: str):
    """The kernel name (as the launch counts have it) of a profiled CUDA
    kernel's symbol; step_losses drops the names of PyTorch's own."""
    m = re.search(r"(\w+)_kernel<([^>]*)>", key)
    if not m:
        return None
    name, targs = m.group(1), [t.strip() for t in m.group(2).split(",")]
    if name in ("fit_levels", "owner_crush"):
        return name + ("_natural" if targs[-1] == "true" else "")
    if name == "encode_region":   # one template: P = 64 is the fixed grid's kernel
        return "encode_fixed_p64" if targs[0] == "64" else f"encode_region_p{targs[0]}"
    # the region encode's cluster kernel and the segment encode's <CH, 8>
    # instances run every P above 4096; the steps profiled run them at P =
    # 16,384 alone
    if name == "encode_region_cluster":
        return "encode_region_p16384"
    # <CH, log2 of P / 64>: P = 256 on the one-warp template, P >= 1024 on
    # the cluster design's two kernels
    if name in ("segment_cluster", "segment_prep") or (name == "segment_encode"
                                                       and targs[1:2] != ["0"]):
        return f"segment_encode_p{64 << int(targs[1])}"
    return {"seg_scan": "seg_mixed_all", "crush_eval": "crush_eval_rows"}.get(name, name)


def step_losses(profile: dict, bounds: dict) -> dict:
    """Each kernel's ms lost above its bound in one step: its profiler
    device time in the step less the bound of its launches there."""
    device_ms, ours = {}, set(read_launches())
    for key, us in profile.items():
        name = profiled_kernel_name(key)
        if name in ours:
            device_ms[name] = device_ms.get(name, 0.0) + us / 1e3
    return {name: ms - bounds.get(name, 0.0) for name, ms in device_ms.items()}


def capture_coalesce_calls(fn) -> dict:
    """Run ``fn`` with the four run-coalescing wrappers recording their
    arguments: {wrapper name: [(args, kwargs), ...]}."""
    from limg_tpu_torch import regions
    from limg_tpu_torch.kernels import coalesce as kc

    names = tuple(COALESCE_WRAPPERS)
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


# the run-coalescing wrappers and the kernel each launches
COALESCE_WRAPPERS = {"match_neighbors_kernel": "match_neighbors",
                     "match_pairs_kernel": "match_pairs", "seg_scan": "seg_mixed_all",
                     "segment_encode_kernel": "segment_encode"}


def call_shape(args) -> str:
    """A captured call's shape: its first tensor's, or a scan batch's
    problems as (rows, lanes)."""
    first = args[0]
    if isinstance(first, (list, tuple)):
        return "[" + ", ".join(f"({len(p.rows)}, {p.seg.numel()})" for p in first) + "]"
    return str(tuple(first.shape))


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
        # pair launch (level 2 at 4K), run building's first scan (every
        # level's horizontal run lengths and rectangle test, 129,600 +
        # 32,400 + 8,160 lanes), the full-capacity segment encode
        shapes = {COALESCE_WRAPPERS[k]: v[0] for k, v in calls.items()}
        log(f"  4K {lane} main-path calls: " + ", ".join(
            f"{k} {len(v)}" for k, v in calls.items()) + "; timed shapes: "
            + ", ".join(f"{k} {call_shape(c[0])}" for k, c in shapes.items()))
        mpx = img.shape[0] * img.shape[1] * 1e-6
        for name, (args, kwargs) in shapes.items():
            wrapper = next(k for k, v in COALESCE_WRAPPERS.items() if v == name)
            kern = getattr(kc, wrapper)
            plain = getattr(kc, wrapper.replace("_kernel", "") + "_reference")
            got, want = kern(*args, **kwargs), plain(*args, **kwargs)
            worst = max(worst, compare_outputs(
                got if isinstance(got, (tuple, list)) else [got],
                want if isinstance(want, (tuple, list)) else [want]))
            bound = kernel_bound(name, args, got)
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (time_fn(lambda f=f: f(*args, **kwargs), device)
                              for f in (plain, kern, kern, plain))
            rows[(name, lane)] = (min(k1, k2), min(p1, p2), *bound)
            log(f"  4K {lane} {name}: kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms, "
                f"bound {bound[0]!r} ms ({bound[1]}) [{smi}]")

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
        prof = profile_step(step, device, f"{lane} default merged")
        log_profiled(prof, "segment_encode", rows[("segment_encode", lane)][0], lane, smi)
        if lane == "rgb":
            log(f"  kernel launches per default step: {launches_per_step(step)}")
            losses = step_losses(prof, step_bounds(step))
            log(f"  ms lost above the bound per default step: {losses}")
    log(f"phase 4c ok: 4K run-coalescing kernel outputs equal the plain versions' "
        f"(max abs diff {worst})")
    return rows, worst, losses


def phase_timing_rd(device, smi: str):
    """encode_region vs plain at each P at the 4K shapes of the RD levels
    (also compared), and the RD step."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.regions import _words
    from tools.record_torch_reference import case_images

    log("== phase 4d: region encode kernel and RD step at 4K (CUDA events, median of",
        TIMED_RUNS, "runs)")
    images = case_images(2160, 3840)
    rows, worst = {}, 0.0
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        words = _words(img_d)
        for p in REGION_SIZES:
            packed, mask, grid = layout.blockify_words(words, int(p ** 0.5))
            got = kmod.encode_blocks_kernel(packed, mask, cfg, 0, emit_endpoints=True)
            worst = max(worst, compare_outputs(
                got, kmod.encode_blocks_reference(packed, mask, cfg, 0, emit_endpoints=True)))
            bound = kernel_bound("encode_region", (packed, mask, cfg), got)
            kern = lambda: kmod.encode_blocks_kernel(packed, mask, cfg, 0, emit_endpoints=True)
            plain = lambda: kmod.encode_blocks_reference(packed, mask, cfg, 0, emit_endpoints=True)
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
            rows[(p, lane)] = (min(k1, k2), min(p1, p2), *bound)
            log(f"  4K {lane} encode_region P={p} ({grid.num_blocks} regions): kernel {k1!r} / "
                f"{k2!r} ms, plain {p1!r} / {p2!r} ms, bound {bound[0]!r} ms ({bound[1]}) [{smi}]")
        mpx = img.shape[0] * img.shape[1] * 1e-6
        nb = 270 * 480

        def step():
            state = limg_tpu_torch.fused_rd_pre(img_d, cfg, 0, RD_LAMBDA, MERGED_LEVELS,
                                                need_q=False, device=device)
            cap = limg_tpu_torch.auto_run_capacity(int(state["n_run_blocks"]), nb)
            out = limg_tpu_torch.fused_rd_finish(state, cfg, 0, RD_LAMBDA, MERGED_LEVELS, False,
                                                 cap)
            return out["total_err"], out["mean_bpp"]

        step_ms = time_fn(step, device)
        log(f"  4K {lane} RD step (fused_rd_pre, host capacity read, fused_rd_finish; "
            f"emit_planes=False): {step_ms!r} ms = {mpx / step_ms * 1e3!r} Mpx/s [{smi}]")
        prof = profile_step(step, device, f"{lane} RD")
        if lane == "rgb":
            log(f"  kernel launches per RD step: {launches_per_step(step)}")
            losses = step_losses(prof, step_bounds(step))
            log(f"  ms lost above the bound per RD step: {losses}")
    log(f"phase 4d ok: 4K region kernel outputs equal the plain version's (max abs diff {worst})")
    return rows, worst, losses


def phase_timing_natural(device, smi: str):
    """The natural pair vs plain and vs the Morton pair, crush_eval_rows vs
    plain at the composed pass's first call, the composed coalesce pass vs
    the segment kernel's, and the natural default step vs the Morton one, at
    4K (the kernels also compared)."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import crush_eval as kce
    from limg_tpu_torch.kernels import encode_merged as km
    from limg_tpu_torch.kernels import encode_natural as kn
    from limg_tpu_torch.regions import _words
    from tools.record_torch_reference import case_images

    log("== phase 4e: natural pair, crush_eval_rows, composed coalesce pass and natural step "
        "at 4K (CUDA events, median of", TIMED_RUNS, "runs)")
    images = case_images(2160, 3840)
    rows, worst, lv = {}, 0.0, MERGED_LEVELS
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        words = _words(img_d)
        fit = kn.fit_levels_natural_reference(words, cfg, lv)
        worst = max(worst, compare_outputs(kn.fit_levels_natural_kernel(words, cfg, lv), fit))
        args = (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, lv, 0)
        worst = max(worst, compare_outputs(kn.owner_crush_natural_kernel(*args),
                                           kn.owner_crush_natural_reference(*args)))
        m_fit = km.fit_levels_kernel(words, cfg, lv)
        m_args = (words, m_fit.owner, m_fit.f8_sel, m_fit.eps_sel, cfg, lv, 0)
        fns = {"fit_levels_natural": (lambda: kn.fit_levels_natural_kernel(words, cfg, lv),
                                      lambda: kn.fit_levels_natural_reference(words, cfg, lv),
                                      lambda: km.fit_levels_kernel(words, cfg, lv),
                                      (words, cfg, lv)),
               "owner_crush_natural": (lambda: kn.owner_crush_natural_kernel(*args),
                                       lambda: kn.owner_crush_natural_reference(*args),
                                       lambda: km.owner_crush_kernel(*m_args), args)}
        for name, (kern, plain, twin, call) in fns.items():
            bound = kernel_bound(name, call, kern())
            # plain, kernel, Morton twin, twin, kernel, plain: one card state
            p1, k1, t1, t2, k2, p2 = (time_fn(f, device)
                                      for f in (plain, kern, twin, twin, kern, plain))
            rows[(name, lane)] = (min(k1, k2), min(p1, p2), *bound)
            log(f"  4K {lane} {name}: kernel {k1!r} / {k2!r} ms, Morton twin {t1!r} / {t2!r} ms, "
                f"plain {p1!r} / {p2!r} ms, bound {bound[0]!r} ms ({bound[1]}) [{smi}]")

        # the composed coalesce pass's crush evaluations, on the default state
        state = limg_tpu_torch.fused_merged_pre(img_d, cfg, 0, lv, device=device)
        calls, saved = [], kce.crush_eval_rows_kernel

        def spy(*a):
            calls.append(a)
            return saved(*a)

        kce.crush_eval_rows_kernel = spy
        try:
            composed_pass(state, cfg, 0, False)
        finally:
            kce.crush_eval_rows_kernel = saved
        # both calls: the ladder's 27 axis sweeps over the whole buffer (a
        # stride-0 table; its row in the kernels line) and its 8 verified
        # candidates (one triple a block)
        for i, ce_args in enumerate(calls):
            got = kce.crush_eval_rows_kernel(*ce_args)
            worst = max(worst, compare_outputs(got, kce.crush_eval_rows_reference(*ce_args)))
            bound = kernel_bound("crush_eval_rows", ce_args, got)
            kern = lambda: kce.crush_eval_rows_kernel(*ce_args)
            plain = lambda: kce.crush_eval_rows_reference(*ce_args)
            p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
            if i == 0:
                rows[("crush_eval_rows", lane)] = (min(k1, k2), min(p1, p2), *bound)
            form = "table" if kce.table_of(ce_args[4]) is not None else "per-block"
            log(f"  4K {lane} crush_eval_rows, call {i + 1} of {len(calls)} in the composed pass "
                f"(K = {ce_args[4].shape[0]}, {form}, N = {ce_args[0].shape[1]}): kernel {k1!r} / "
                f"{k2!r} ms, plain {p1!r} / {p2!r} ms, bound {bound[0]!r} ms ({bound[1]}) [{smi}]")
        seg_pass = lambda: composed_pass(state, cfg, 0, True)[0]["dist"]
        comp_pass = lambda: composed_pass(state, cfg, 0, False)[0]["dist"]
        s1, c1, c2, s2 = (time_fn(f, device) for f in (seg_pass, comp_pass, comp_pass, seg_pass))
        log(f"  4K {lane} coalesce pass at auto capacity: composed (use_kernel=False) {c1!r} / "
            f"{c2!r} ms, segment kernel {s1!r} / {s2!r} ms [{smi}]")

        mpx = img.shape[0] * img.shape[1] * 1e-6
        nb = state["grid"].num_blocks

        def step(layout):
            st = limg_tpu_torch.fused_merged_pre(img_d, cfg, 0, lv, need_q=False,
                                                 fused_layout=layout, device=device)
            cap = limg_tpu_torch.auto_run_capacity(int(st["n_run_blocks"]), nb)
            out = limg_tpu_torch.fused_merged_finish(st, cfg, 0, lv, False, cap,
                                                     fused_layout=layout)
            return out["total_err"], out["mean_bpp"]

        m1, n1, n2, m2 = (time_fn(lambda lay=lay: step(lay), device)
                          for lay in ("morton", "natural", "natural", "morton"))
        log(f"  4K {lane} default step (fused_merged_pre, host capacity read, "
            f"fused_merged_finish; emit_planes=False): natural {n1!r} / {n2!r} ms = "
            f"{mpx / min(n1, n2) * 1e3!r} Mpx/s, Morton {m1!r} / {m2!r} ms [{smi}]")
        if lane == "rgb":
            prof = profile_step(lambda: step("natural"), device, f"{lane} natural default")
            log_profiled(prof, "fit_levels", rows[("fit_levels_natural", lane)][0], lane, smi)
    log(f"phase 4e ok: 4K natural and crush_eval_rows outputs equal the plain versions' "
        f"(max abs diff {worst})")
    return rows, worst


def phase_timing_dense(device, smi: str):
    """segment_encode at P = 256, 1024 and 4096 vs plain at the 4K shapes of
    the dense levels (also compared; captured from a 4-level dense encode),
    and the dense 3-level step's device time."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import coalesce as kc
    from tools.record_torch_reference import case_images

    log("== phase 4f: segment_encode at P = 256 / 1024 / 4096 and the dense step at 4K "
        "(CUDA events, median of", TIMED_RUNS, "runs)")
    images = case_images(2160, 3840)
    rows, worst, losses = {}, 0.0, {}
    for lane, img in images.items():
        cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
        img_d = _as_image_tensor(img, device)
        calls = capture_coalesce_calls(lambda: limg_tpu_torch.encode_image_merged(
            img_d, cfg, num_levels=4, fused=False, fetch_planes=False, device=device))
        for args, kwargs in calls["segment_encode_kernel"]:
            p = args[0].shape[0]
            if p not in SEGMENT_SIZES:
                continue
            got = kc.segment_encode_kernel(*args, **kwargs)
            worst = max(worst, compare_outputs(got, kc.segment_encode_reference(*args, **kwargs)))
            bound = kernel_bound("segment_encode", args, got)
            kern = lambda: kc.segment_encode_kernel(*args, **kwargs)
            plain = lambda: kc.segment_encode_reference(*args, **kwargs)
            # plain, kernel, kernel, plain: both see the same card state
            p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
            members = int(args[1].any(dim=0).sum())
            rows[(p, lane)] = (min(k1, k2), min(p1, p2), *bound)
            log(f"  4K {lane} segment_encode P={p} ({args[0].shape[1]} lanes, {members} with a "
                f"member pixel): kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms, bound "
                f"{bound[0]!r} ms ({bound[1]}) [{smi}]")
        mpx = img.shape[0] * img.shape[1] * 1e-6

        def step():
            out = limg_tpu_torch.encode_image_merged_device(img_d, cfg, num_levels=MERGED_LEVELS,
                                                            emit_planes=False, cap_frac=1,
                                                            device=device)
            return out["total_err"], out["mean_bpp"]

        step_ms = time_fn(step, device)
        log(f"  4K {lane} dense step (encode_image_merged_device, 3 levels, full run capacity, "
            f"emit_planes=False): {step_ms!r} ms = {mpx / step_ms * 1e3!r} Mpx/s [{smi}]")
        prof = profile_step(step, device, f"{lane} dense", by_op=lane == "rgb")
        if lane == "rgb":
            log(f"  kernel launches per dense step: {launches_per_step(step)}")
            losses = step_losses(prof, step_bounds(step))
            log(f"  ms lost above the bound per dense step: {losses}")
    log(f"phase 4f ok: 4K segment_encode outputs at P = 256 / 1024 / 4096 equal the plain "
        f"version's (max abs diff {worst})")
    return rows, worst, losses


def phase_timing_levels(device, smi: str):
    """The region encode (encode_region_p16384 / _p65536 / _p262144) on the
    4K image's level-4, level-5 and level-6 regions and the segment encode
    at P = 16,384 and 65,536 on the buffers of a 6-level dense encode
    (captured), each against its plain version (also compared) and its
    bound; the dense 5-level step's events time, device busy and kernel
    launches (4K RGB)."""
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import encode_fixed as kmod
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.regions import _words
    from tools.record_torch_reference import case_images

    log("== phase 4h: region encodes at P = 16,384 / 65,536 / 262,144, segment encodes at P = "
        "16,384 / 65,536 and the 5-level dense step at 4K RGB (CUDA events, median of",
        TIMED_RUNS, "runs)")
    img = case_images(2160, 3840)["rgb"]
    cfg = EncodeConfig(error_factor=100)
    img_d = _as_image_tensor(img, device)
    rows, worst = {}, 0.0

    def timed(name, kern, plain, got, bound, shape):
        nonlocal worst
        worst = max(worst, compare_outputs(got, plain()))
        # plain, kernel, kernel, plain: both see the same card state
        p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
        rows[name] = (min(k1, k2), min(p1, p2), *bound)
        log(f"  4K rgb {name} ({shape}): kernel {k1!r} / {k2!r} ms, plain {p1!r} / {p2!r} ms, "
            f"bound {bound[0]!r} ms ({bound[1]}), {bound[0] / min(k1, k2):.4f} of it [{smi}]")

    words = _words(img_d)
    for p in TIMED_REGION_SIZES:
        packed, mask, _ = layout.blockify_words(words, int(p ** 0.5))
        args = (packed, mask, cfg, 0)
        got = kmod.encode_blocks_kernel(*args, emit_endpoints=True)
        timed(f"encode_region_p{p}", lambda: kmod.encode_blocks_kernel(*args, emit_endpoints=True),
              lambda: kmod.encode_blocks_reference(*args, emit_endpoints=True), got,
              kernel_bound("encode_region", args, got), f"{packed.shape[1]} regions")
    calls = capture_coalesce_calls(lambda: limg_tpu_torch.encode_image_merged(
        img_d, cfg, num_levels=6, fused=False, fetch_planes=False, device=device))
    for args, kwargs in calls["segment_encode_kernel"]:
        p = args[0].shape[0]
        if p not in LEVEL_SIZES:
            continue
        got = kc.segment_encode_kernel(*args, **kwargs)
        members = int(args[1].any(dim=0).sum())
        timed(f"segment_encode_p{p}", lambda: kc.segment_encode_kernel(*args, **kwargs),
              lambda: kc.segment_encode_reference(*args, **kwargs), got,
              kernel_bound("segment_encode", args, got),
              f"{args[0].shape[1]} lanes, {members} with a member pixel")
    mpx = img.shape[0] * img.shape[1] * 1e-6

    def step():
        out = limg_tpu_torch.encode_image_merged_device(img_d, cfg, num_levels=5,
                                                        emit_planes=False, cap_frac=1,
                                                        device=device)
        return out["total_err"], out["mean_bpp"]

    step_ms = time_fn(step, device)
    log(f"  4K rgb dense step at 5 levels (encode_image_merged_device, full run capacity, "
        f"emit_planes=False): {step_ms!r} ms = {mpx / step_ms * 1e3!r} Mpx/s [{smi}]")
    prof = profile_step(step, device, "rgb dense 5-level")
    log(f"  kernel launches per 5-level dense step: {launches_per_step(step)}")
    losses = step_losses(prof, step_bounds(step))
    log(f"  ms lost above the bound per 5-level dense step: {losses}")
    log(f"phase 4h ok: the kernels' 4K outputs equal the plain versions' (max abs diff {worst})")
    return rows, worst, losses


def launches_per_step(fn) -> dict:
    """Each kernel's launches in one call of the step ``fn``."""
    reset_launches()
    fn()
    return {k: v for k, v in read_launches().items() if v}


def profile_step(fn, device, lane: str, iters: int = 5, by_op: bool = False):
    """Device time by operation over ``iters`` perf steps (torch.profiler,
    ``utils.timing.profile_device``), and the device-busy share of the
    profiled window; ``by_op`` also logs the device time of the kernels each
    PyTorch operation launched itself, by the operation's name (the
    plain-torch glue; the port's own kernels are launched by no
    operation)."""
    from limg_tpu_torch.utils.timing import profile_device

    prof = profile_device(fn, iters, device=device)
    rows = sorted(prof.kernels.items(), key=lambda r: -r[1])
    busy = prof.busy_us
    log(f"  profile 4K {lane} step: device busy {busy!r} us of {prof.wall_us!r} us wall "
        f"per step, idle share {1 - busy / prof.wall_us!r} (profiler on)")
    for key, us in rows[:8]:
        log(f"    {us!r:>22} us  {key[:90]}")
    if by_op:
        ops = sorted(prof.ops.items(), key=lambda r: -r[1])
        log(f"  profile 4K {lane} step by PyTorch operation: {sum(us for _, us in ops)!r} us "
            f"of device time in {len(ops)} operations")
        for key, us in ops[:20]:
            log(f"    {us!r:>22} us  {key[:90]}")
    return dict(rows)


def log_profiled(profile: dict, kernel: str, events_ms: float, lane: str, smi: str):
    """A kernel's device time in a step's profile (ms per step) beside its
    events time alone."""
    us = sum(v for k, v in profile.items() if f"{kernel}_kernel<" in k)
    log(f"  4K {lane} {kernel}: events {events_ms!r} ms alone, profiler device time "
        f"{us / 1e3!r} ms per step [{smi}]")


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


def streaming_await_all(paths, h: int, w: int, cfg, device, seed: int = 0):
    """encode_corpus_streaming's loop as the JAX package writes it
    (limg_tpu/parallel/corpus.py:74-88): every file staged up front, and
    each wait on the whole pool (``await_all``). Returns (psnr, bpp)."""
    import torch
    from limg_tpu_torch import native
    from limg_tpu_torch.ops.dither import image_seed
    from limg_tpu_torch.parallel import corpus

    pool = native.StagingPool()
    try:
        slots = [pool.stage(p, h, w) for p in paths]
        stats = []
        for i, (packed, mask, status) in enumerate(slots):
            while status[0] == 0:
                pool.await_all()
            if status[0] == 1:
                stats.append(torch.stack(corpus._encode_packed_stats(
                    *corpus._upload(packed, mask, device), cfg, image_seed(seed, i))))
        return torch.stack(stats).cpu().numpy().T
    finally:
        pool.close()


def phase_main_path_corpus(device, tmp: str) -> dict:
    """limg_tpu_torch.parallel on the card: the mesh, the fixed-grid corpus
    (one launch, no host sync), shard bodies on one card, the block-sharded
    4K image, the merged corpus, the multichip gate, the streaming corpus
    and the mixed-size corpus; every kernel's launches counted from 0 over
    the entry points' calls. TGA files go to ``tmp``."""
    import torch
    import limg_tpu_torch
    from limg_tpu_torch import EncodeConfig, native
    from limg_tpu_torch.kernels import encode_fixed as kmod
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

    reset_launches()
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
    before = kmod.launches
    out = mesh.encode_corpus_sharded(batch, nodither, n_devices=1, device=device)
    if kmod.launches != before + 1:
        raise AssertionError(f"{CORPUS_N}-image shard: {kmod.launches - before} launches, not 1")
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
    before = kmod.launches
    split = mesh._fetch(*mesh._corpus_sharded(batch_d, nodither, (device,) * CORPUS_N, 0))
    for key in ("psnr", "bpp"):
        if not np.array_equal(split[key], out[key]):
            raise AssertionError(f"8 shard bodies on one card: {key} differs from one shard")
    log(f"  {CORPUS_N} shard bodies on {device} ({kmod.launches - before} launches): per-image "
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
    launched = read_launches()
    ran = {k: v for k, v in launched.items() if v}
    log(f"phase 3h ok: kernel launches over the corpus calls {ran}")
    return launched


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


def phase_timing_fixed_planes(device, smi: str):
    """fixed_planes against the composition it replaces, bit-equal in value
    and layout on three grids: phase 3's 4K grid (480 blocks a row, so 64-block
    tiles cross block rows), a ragged one (edge blocks cut, a tail tile) and
    the benchmark's; timed beside it by CUDA events on the benchmark's grid.
    Returns the rows and the max abs diff over every output compared."""
    import torch
    from limg_tpu_torch.kernels import fixed_planes as kfp

    with open(FIXTURE) as f:
        case = json.load(f)["cases"]["4k_rgb_nodither"]
    sizes = ((case["height"], case["width"]), FIXED_PLANES_RAGGED, FIXED_PLANES_SIZE)
    log("== phase 4i: the fixed grid's epilogue on",
        ", ".join("x".join(map(str, hw[::-1])) for hw in sizes),
        "timed at", "x".join(map(str, FIXED_PLANES_SIZE[::-1])),
        "(CUDA events, median of", TIMED_RUNS, "runs)")
    rows, worst = {}, 0.0
    for hw in sizes:
        for ch, lane in ((3, "rgb"), (4, "rgba")):
            q, dec, grid = fixed_planes_words(*hw, ch, device)
            got = kfp.fixed_planes_kernel(q, dec, ch, grid)
            want = kfp.fixed_planes_reference(q, dec, ch, grid)
            torch.cuda.synchronize(device)
            worst = max(worst, compare_outputs(got, want))
            for name, g, w_ in zip(("factors", "decoded", "image"), got, want):
                if g.stride() != w_.stride():
                    raise AssertionError(f"{hw} {lane} {name}: strides {g.stride()} vs "
                                         f"{w_.stride()}")
            if hw != FIXED_PLANES_SIZE:
                continue
            bound = kernel_bound("fixed_planes", (q, dec), got)
            nbytes = tensor_bytes((q, dec), got)
            planes = want[1]
            # plain, kernel, kernel, plain: both see the same card state
            stacks1 = time_fn(lambda: kfp.fixed_planes_reference(q, dec, ch), device)
            assemble1 = time_fn(lambda: kfp.assemble_decoded(planes, grid, ch), device)
            k1 = time_fn(lambda: kfp.fixed_planes_kernel(q, dec, ch, grid), device)
            k2 = time_fn(lambda: kfp.fixed_planes_kernel(q, dec, ch, grid), device)
            stacks2 = time_fn(lambda: kfp.fixed_planes_reference(q, dec, ch), device)
            assemble2 = time_fn(lambda: kfp.assemble_decoded(planes, grid, ch), device)
            k_ms = min(k1, k2)
            p_ms = min(stacks1, stacks2) + min(assemble1, assemble2)
            rows[lane] = (k_ms, p_ms, *bound)
            log(f"  {lane}: kernel {k1!r} / {k2!r} ms, {nbytes / k_ms * 1e-6:.1f} GB/s = "
                f"{100 * bound[0] / k_ms:.1f}% of the bound {bound[0]!r} ms ({nbytes / 1e9:.3f} "
                f"GB, {bound[1]}); the two stacks {stacks1!r} / {stacks2!r} ms, "
                f"assemble_decoded {assemble1!r} / {assemble2!r} ms [{smi}]")
            del planes
        del got, want
    log(f"phase 4i ok: the epilogue equals the plain composition on the three grids (max abs "
        f"diff {worst})")
    return rows, worst


def phase_timing_corpus(device, smi: str, tmp: str):
    """The corpus paths' times: the 8 x 1080p fixed-grid corpus in one
    launch against 8 encode_perf_step calls (and its kernel alone against
    its plain version and bound), the 8 x 1080p merged corpus (CUDA events,
    median of TIMED_RUNS), and four host walls of the 32-file streaming
    corpus (median of HOST_RUNS): staging alone, encode alone, the
    streaming loop, and the same loop with the JAX package's await_all."""
    import torch
    from limg_tpu_torch import EncodeConfig, encode_perf_step, native
    from limg_tpu_torch.kernels.encode_fixed import encode_blocks_kernel, encode_blocks_reference
    from limg_tpu_torch.ops.dither import image_seed
    from limg_tpu_torch.parallel import corpus, mesh

    log("== phase 4g: corpus paths at 1080p (CUDA events, median of", TIMED_RUNS,
        "runs; host walls, median of", HOST_RUNS, "runs)")
    h, w = CORPUS_HW
    cfg = EncodeConfig(error_factor=100)
    paths = sorted(os.path.join(tmp, f) for f in os.listdir(tmp) if f.startswith("corpus"))
    batch = np.stack([native.read_tga(p)[..., :3] for p in paths[:CORPUS_N]])
    batch_d = torch.from_numpy(batch).to(device)
    mesh1 = mesh.make_mesh(1, device=device.type)
    mpx = CORPUS_N * h * w * 1e-6

    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    mesh._fetch(*mesh._corpus_sharded(batch_d, cfg, mesh1, 0))
    peak = torch.cuda.max_memory_allocated(device) - base
    corpus_ms = time_fn(lambda: mesh._corpus_sharded(batch_d, cfg, mesh1, 0), device)
    steps_ms = time_fn(lambda: [encode_perf_step(im, cfg, 0, device) for im in batch_d], device)
    log(f"  fixed-grid corpus {CORPUS_N} x 1080p, one launch: {corpus_ms!r} ms = "
        f"{mpx / corpus_ms * 1e3!r} Mpx/s; {CORPUS_N} encode_perf_step calls {steps_ms!r} ms = "
        f"{mpx / steps_ms * 1e3!r} Mpx/s; the shard's device memory above its images "
        f"{peak / 2**20!r} MiB [{smi}]")
    prof = profile_step(lambda: mesh._corpus_sharded(batch_d, cfg, mesh1, 0), device,
                        f"corpus {CORPUS_N}x1080p")
    busy_ms = sum(prof.values()) / 1e3
    log(f"  fixed-grid corpus: device busy {busy_ms / CORPUS_N!r} ms per image, events "
        f"{corpus_ms / CORPUS_N!r} ms per image [{smi}]")
    blocks = [mesh._packed_blocks(im) for im in batch_d]
    packed = torch.cat([b[0] for b in blocks], dim=1)
    mask = torch.cat([b[1] for b in blocks], dim=1)
    worst = compare_outputs(encode_blocks_kernel(packed, mask, cfg, 0, emit_endpoints=True),
                            encode_blocks_reference(packed, mask, cfg, 0, emit_endpoints=True))
    bound = kernel_bound("encode_fixed_p64", (packed, mask, cfg),
                         encode_blocks_kernel(packed, mask, cfg, 0))
    kern = lambda: encode_blocks_kernel(packed, mask, cfg, 0)
    plain = lambda: encode_blocks_reference(packed, mask, cfg, 0)
    p1, k1, k2, p2 = (time_fn(f, device) for f in (plain, kern, kern, plain))
    log(f"  encode_fixed_p64 on the shard ({packed.shape[1]} blocks): kernel {k1!r} / {k2!r} ms, "
        f"plain {p1!r} / {p2!r} ms, bound {bound[0]!r} ms ({bound[1]}); max abs diff {worst} "
        f"[{smi}]")

    merged_ms = time_fn(lambda: mesh.encode_corpus_sharded_merged(
        batch_d, cfg, n_devices=1, num_levels=MERGED_LEVELS, device=device), device)
    log(f"  merged corpus {CORPUS_N} x 1080p (fused, {MERGED_LEVELS} levels, with its fetch): "
        f"{merged_ms!r} ms = {mpx / merged_ms * 1e3!r} Mpx/s [{smi}]")

    smpx = len(paths) * h * w * 1e-6

    def staging_alone():
        pool = native.StagingPool()
        try:
            slots = [pool.stage(p, h, w) for p in paths]
            pool.await_all()
        finally:
            pool.close()
        return slots, pool.threads

    def encode_alone(slots):
        stats = [torch.stack(corpus._encode_packed_stats(*corpus._upload(p, m, device), cfg,
                                                         image_seed(0, i)))
                 for i, (p, m, _) in enumerate(slots)]
        return torch.stack(stats).cpu()

    stage_ms, (slots, threads) = host_ms(staging_alone)
    encode_ms, _ = host_ms(lambda: encode_alone(slots))
    walls = {"streaming": [], "await_all": []}
    for r in range(HOST_RUNS):      # the two loops in turns, each first in turn
        for name in (("streaming", "await_all") if r % 2 == 0 else ("await_all", "streaming")):
            t0 = time.perf_counter()
            if name == "streaming":
                corpus.encode_corpus_streaming(paths, h, w, cfg, device=device)
            else:
                streaming_await_all(paths, h, w, cfg, device)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    stream_ms, await_ms = (float(np.median(walls[k])) for k in ("streaming", "await_all"))
    log(f"  streaming corpus, {len(paths)} TGA files of 1080p, {threads} pool "
        f"threads (host wall ms, median of {HOST_RUNS}): staging alone {stage_ms!r}, "
        f"encode alone (pre-staged) {encode_ms!r}, encode_corpus_streaming {stream_ms!r} "
        f"({walls['streaming']}; {smpx / stream_ms * 1e3!r} Mpx/s), the await_all loop "
        f"{await_ms!r} ({walls['await_all']}; {smpx / await_ms * 1e3!r} Mpx/s) [{smi}]")
    log(f"phase 4g ok: the shard's kernel outputs equal the plain version's (max abs diff "
        f"{worst})")
    return worst


def kernel_row(name, source, replaces, launches, max_abs_err, timing) -> dict:
    """``timing``: (ms, plain ms, bound ms, bound by[, library ms]); only
    seg_sum_fold's function has a PyTorch call (``index_add_``)."""
    k_ms, p_ms, bound_ms, bound_by, lib_ms = (*timing, None)[:5]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def main():
    sys.path.insert(0, ROOT)
    import torch

    smi = phase_environment()
    device = torch.device("cuda", 0)
    phase_build()
    worst = phase_compare(device)
    worst_m = phase_compare_merged(device)
    worst_c = phase_compare_coalesce(device)
    worst_r = phase_compare_region(device)
    worst_n = phase_compare_natural(device)
    worst_s = phase_compare_segment_regions(device)
    worst_l = phase_compare_large(device)
    launched, launched_fp = phase_main_path(device)
    launched_m = phase_main_path_merged(device)
    launched_c = phase_main_path_coalesce(device)
    launched_r = phase_main_path_rd(device)
    launched_n = phase_main_path_natural(device)
    phase_ltp1(device, smi)
    launched_d = phase_main_path_dense(device)
    launched_l = phase_main_path_levels(device)
    launched_j, worst_j, row_j = phase_main_path_scatter(device, smi)
    with tempfile.TemporaryDirectory() as tmp:      # the streamed corpus's TGA files
        launched_h = phase_main_path_corpus(device, tmp)
        rows, worst4k = phase_timing(device, smi)
        rows_m, worst4k_m = phase_timing_merged(device, smi)
        rows_c, worst4k_c, lost_default = phase_timing_coalesce(device, smi)
        rows_r, worst4k_r, lost_rd = phase_timing_rd(device, smi)
        rows_n, worst4k_n = phase_timing_natural(device, smi)
        rows_d, worst4k_d, lost_dense = phase_timing_dense(device, smi)
        rows_l, worst4k_l, lost_levels = phase_timing_levels(device, smi)
        worst_g = phase_timing_corpus(device, smi, tmp)
    rows_fp, worst_fp = phase_timing_fixed_planes(device, smi)
    # the 4K RGB lane; RGBA is printed above
    kernels = [kernel_row("encode_fixed_p64", KERNEL_SOURCE, REPLACES,
                          launched + launched_h["encode_fixed_p64"],
                          max(worst, worst4k, worst_g), rows["rgb"])]
    for name, replaces in MERGED_REPLACES.items():
        kernels.append(kernel_row(name, MERGED_SOURCE, replaces, launched_m[name],
                                  max(worst_m, worst4k_m), rows_m[(name, "rgb")]))
    for name, replaces in COALESCE_REPLACES.items():
        kernels.append(kernel_row(name, COALESCE_SOURCE, replaces, launched_c[name],
                                  max(worst_c, worst4k_c), rows_c[(name, "rgb")]))
    for p in REGION_SIZES:
        name = f"encode_region_p{p}"
        kernels.append(kernel_row(name, REGION_SOURCE, REPLACES, launched_r[name],
                                  max(worst_r, worst4k_r), rows_r[(p, "rgb")]))
    for name, replaces in NATURAL_REPLACES.items():
        kernels.append(kernel_row(name, NATURAL_SOURCE, replaces, launched_n[name],
                                  max(worst_n, worst4k_n), rows_n[(name, "rgb")]))
    # crush_eval_rows' launches: the composed coalesce pass (phase 3e) and
    # the scatter crush (phase 3j)
    kernels.append(kernel_row("crush_eval_rows", CRUSH_EVAL_SOURCE, CRUSH_EVAL_REPLACES,
                              launched_n["crush_eval_rows"] + launched_j["crush_eval_rows"],
                              max(worst_n, worst4k_n, worst_j),
                              rows_n[("crush_eval_rows", "rgb")]))
    kernels.append(kernel_row("seg_sum_fold", SEG_FOLD_SOURCE, SEG_FOLD_REPLACES,
                              launched_j["seg_sum_fold"], worst_j, row_j))
    kernels.append(kernel_row("fixed_planes", FIXED_PLANES_SOURCE, FIXED_PLANES_REPLACES,
                              launched_fp, worst_fp, rows_fp["rgb"]))
    for p in SEGMENT_SIZES:
        name = f"segment_encode_p{p}"
        kernels.append(kernel_row(name, SEGMENT_REGION_SOURCE, COALESCE_REPLACES["segment_encode"],
                                  launched_d[name], max(worst_s, worst4k_d), rows_d[(p, "rgb")]))
    # the dense path's levels 4 and 5 (launches: phase 3i's 5- and 6-level
    # encodes)
    for p in LEVEL_SIZES:
        name = f"encode_region_p{p}"
        kernels.append(kernel_row(name, REGION_SOURCE, REPLACES, launched_l[name],
                                  max(worst_l, worst4k_l), rows_l[name]))
    for p in LEVEL_SIZES:
        name = f"segment_encode_p{p}"
        kernels.append(kernel_row(name, SEGMENT_REGION_SOURCE,
                                  "limg_tpu/pallas_kernels/encode_segments.py:205",
                                  launched_l[name], max(worst_l, worst4k_l), rows_l[name]))
    # the order in which to redesign the kernels: first any slower than a
    # PyTorch call, then by the time they lose above the bound in one
    # default merged step, then in one RD step (each kernel's profiler
    # device time in the step less the bounds of its launches there at
    # their own shapes, phases 4c and 4d)
    def lost(k, losses):
        return losses.get(k["name"], 0.0)

    behind = sorted(kernels, key=lambda k: (k["library_ms"] is None or k["ms"] <= k["library_ms"],
                                            -lost(k, lost_default), -lost(k, lost_rd)))
    log("redesign order (ms lost above the bound per default step / per RD step: device time "
        "in the step less the launches' bounds, 4K RGB): " + ", ".join(
            f"{k['name']} {lost(k, lost_default):.3f} / {lost(k, lost_rd):.3f}" for k in behind))
    log("ms lost above the bound per dense step (3 levels, 4K RGB): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(lost_dense.items(), key=lambda kv: -kv[1])))
    log("ms lost above the bound per dense step (5 levels, 4K RGB): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(lost_levels.items(), key=lambda kv: -kv[1])))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
