"""Price the phases of the one-warp-a-region segment encode
(``csrc/segment_encode.cuh``) with ``clock64()`` stamps on one CUDA card,
at P = 64 (``csrc/coalesce.cu``'s instance, on the 4K default encode's run
buffer of 129,600 lanes) or P = 256 (``csrc/segment_region.cu``'s, on the
dense path's level-1 buffer).

    python3 tools/stamp_segment_phases.py [--p 64 256] [--lane rgb rgba] [--root DIR]

The tool copies the ``limg_tpu_torch/csrc`` of this checkout (or of the
checkout at DIR) to ``build/stamped/``, adds to its
``segment_encode_kernel`` a CTA barrier and a ``clock64()`` stamp of
thread 0 at the start of each phase (pixel counts, channel sums,
directions, factor extremes, endpoints and factors, the crush search's
sweeps and its lattice keys and verification, decode, end), builds
``coalesce.cu`` or ``segment_region.cu`` with nvcc and the package's flags
(each P's build in parallel), and runs it once on the segment encode's
inputs: at P = 64 those of the default 4K encode
(``encode_image_merged()``), at P = 256 those of a 4-level dense encode
(``encode_image_merged(fused=False)``), both ladder K = 8. It prints, over
the CTAs that reach the end, each phase's share of the summed CTA cycles
and of the longest CTA's, and checks the stamped build's outputs against
the plain version. The added barriers change the timing a little; the
shares are what it is for. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("start", "pixel counts", "channel sums", "directions", "factor extremes",
          "endpoints and factors", "crush: sweeps", "crush: keys, verification",
          "decode and outputs")
# the phase comments of segment_encode_kernel a stamp goes before; the
# ladder's keys comment sits in its crush-mode branch (uniform over the CTA)
MARKERS = ("  // ---- segment pixel counts", "  // ---- fit: channel sums -> avg",
           "  // ---- fit: the three directions", "  // ---- fit: factor extremes",
           "  // ---- fit: endpoints, factors", "  // ---- crush search",
           "    // lattice keys", "  // ---- dither, decode and the outputs")
SLOTS = 16       # stamps a CTA
# P -> (library, its C entry point, pointer arguments after the key, the
# segment starts a CTA takes: segment_encode.cuh seg_tile)
INSTANCES = {64: ("coalesce", "limg_segment_encode", 10, 128),
             256: ("segment_region", "limg_segment_encode_region", 11, 32)}
STAMP_DECL = "\n__device__ long long limg_stamps[1 << 21];\n"
READER = """
extern "C" int limg_read_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, limg_stamps, sizeof(long long) * n);
}
extern "C" int limg_clear_stamps() {
  void* at = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&at, limg_stamps);
  return (int)(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof(limg_stamps)));
}
"""


def stamp(k: int) -> str:
    return (f"  __syncthreads();\n  if (threadIdx.x == 0)\n"
            f"    limg_stamps[(size_t)blockIdx.x * {SLOTS} + {k}] = clock64();\n")


def stamped_source(text: str) -> str:
    """segment_encode.cuh with the stamps."""
    head, sep, rest = text.partition("segment_encode_kernel(const SegParams P) {\n")
    if not sep:
        raise ValueError("no segment_encode_kernel(const SegParams P) in the source")
    body, sep2, tail = rest.partition("\ntemplate <int CH, int LOGC>\nint launch_segment_encode")
    first = body.index("\n", body.index("const int tid = threadIdx.x")) + 1
    body = body[:first] + stamp(0) + body[first:]
    for k, marker in enumerate(MARKERS, start=1):
        if body.count(marker) != 1:
            raise ValueError(f"phase marker {marker.strip()!r} found {body.count(marker)} times")
        body = body.replace(marker, stamp(k) + marker, 1)
    end = body.rindex("}")
    body = body[:end] + stamp(len(MARKERS) + 1) + body[end:]
    inc = '#include "limg_common.cuh"\n'
    if inc not in head:
        raise ValueError("no limg_common.cuh include in the source")
    return head.replace(inc, inc + STAMP_DECL, 1) + sep + body + sep2 + tail


def build_stamped(csrc: Path, p: int) -> Path:
    """The stamped copy of csrc's library of P, built; its path."""
    from limg_tpu_torch.kernels import build

    library = INSTANCES[p][0]
    out_dir = ROOT / "build" / "stamped" / f"p{p}"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    header = out_dir / "segment_encode.cuh"
    header.write_text(stamped_source(header.read_text()))
    entry = out_dir / f"{library}.cu"
    entry.write_text(entry.read_text() + READER)
    so = out_dir / f"lib{library}_stamped.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(entry)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {entry}:\n{proc.stdout}{proc.stderr}")
    return so


def segment_inputs(p: int, lane: str, device):
    """The segment encode's call at P on the 4K test image of ``lane``:
    (packed_c, mask_c, seg_c, blocks, cfg, key), kwargs."""
    import limg_tpu_torch
    from chip_smoke import capture_coalesce_calls
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from tools.record_torch_reference import case_images

    img = case_images(2160, 3840)[lane]
    cfg = EncodeConfig(error_factor=100, has_alpha=lane == "rgba")
    img_d = _as_image_tensor(img, device)
    if p == 64:
        run = lambda: limg_tpu_torch.encode_image_merged(img_d, cfg, fetch_planes=False,
                                                         device=device)
    else:
        run = lambda: limg_tpu_torch.encode_image_merged(img_d, cfg, num_levels=4, fused=False,
                                                         fetch_planes=False, device=device)
    calls = capture_coalesce_calls(run)
    return next((a, kw) for a, kw in calls["segment_encode_kernel"] if a[0].shape[0] == p)


def stamp_run(so: Path, p: int, lane: str, device, smi: str) -> None:
    """One stamped launch at P on ``lane``'s buffer; prints the shares."""
    import torch
    from chip_smoke import compare_outputs
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels import launch

    _, fn_name, n_ptr, tile = INSTANCES[p]
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, fn_name)
    fn.argtypes = [ptr] * 4 + [i32] * 9 + [ctypes.c_uint32] + [ptr] * n_ptr
    fn.restype = i32
    lib.limg_read_stamps.argtypes = [ptr, i32]

    (packed_c, mask_c, seg_c, blocks, cfg_c, key), kw = segment_inputs(p, lane, device)
    n = packed_c.shape[1]
    ch = cfg_c.channels
    if lib.limg_clear_stamps() != 0:   # a CTA that stops early stamps nothing
        raise SystemExit("clearing the stamps failed")

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    packed_bm, mask_bm = packed_c.t().contiguous(), mask_c.t().contiguous()
    f8 = empty(n, p)
    got = kc.SegmentEncode(shifts=empty(3, n), q=empty(n, p), dec=empty(n, p),
                           dist_blk=empty(n, dtype=torch.float32), count_blk=empty(n),
                           count_mem=empty(n), eps=empty(6, ch, n),
                           avg=empty(ch, n, dtype=torch.float32))
    # the region library takes one more pointer (the cluster design's
    # scratch, which P = 256 ignores) before the stream
    extra = (None,) * (n_ptr - 10)
    rc = fn(packed_bm.data_ptr(), mask_bm.data_ptr(), seg_c.data_ptr(), blocks.data_ptr(), n, p,
            ch, *launch.crush_args(cfg_c, key), f8.data_ptr(),
            *(t.data_ptr() for t in got), *extra, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"stamped launch failed ({rc})")
    torch.cuda.synchronize(device)
    want = kc.segment_encode_reference(packed_c, mask_c, seg_c, blocks, cfg_c, key, **kw)
    compare_outputs(got._replace(q=None if want.q is None else got.q.t(), dec=got.dec.t()), want)
    grid = -(-n // tile)
    host = np.zeros(grid * SLOTS, np.int64)
    if lib.limg_read_stamps(host.ctypes.data, host.size) != 0:
        raise SystemExit("reading the stamps failed")
    st = host.reshape(grid, SLOTS)[:, :len(PHASES) + 1]
    done = st[(st > 0).all(axis=1)]
    spans = np.diff(done, axis=1).astype(np.float64)
    total = spans.sum()
    longest = spans[spans.sum(1).argmax()]
    members = int(mask_c.any(dim=0).sum())
    print(f"4K {lane} segment_encode P={p}: {n} lanes ({members} with a member pixel), "
          f"{grid} CTAs, {len(done)} reach the end; cycles summed over them {total:.0f}, "
          f"the longest CTA {longest.sum():.0f} [{smi}]")
    for name, cyc, lng in zip(PHASES, spans.sum(0), longest):
        print(f"  {name:28s} {cyc / total:7.2%} of the summed cycles, {lng / longest.sum():7.2%} "
              f"of the longest CTA's ({lng:.0f})")
    print("stamped build bit-equal to the plain version", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, nargs="+", choices=sorted(INSTANCES), default=[256])
    ap.add_argument("--lane", nargs="+", choices=("rgb", "rgba"), default=["rgb"])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose csrc is stamped (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this tool needs a CUDA card")
    from chip_smoke import run_text

    device = torch.device("cuda", 0)
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                    "--format=csv,noheader"])
    print("card:", smi, "; csrc of", args.root.resolve(), flush=True)
    csrc = args.root.resolve() / "limg_tpu_torch" / "csrc"
    with ThreadPoolExecutor(len(args.p)) as pool:
        libs = dict(zip(args.p, pool.map(lambda p: build_stamped(csrc, p), args.p)))
    for p in args.p:
        for lane in args.lane:
            stamp_run(libs[p], p, lane, device, smi)


if __name__ == "__main__":
    main()
