"""Price the phases of the one-warp-a-region segment encode at P = 256
(``csrc/segment_encode.cuh`` as ``csrc/segment_region.cu`` instantiates it:
the dense path's level-1 buffer) with ``clock64()`` stamps, on the 4K dense
buffer, on one CUDA card.

    python3 tools/stamp_segment_phases.py [--lane rgb]

The tool copies this checkout's ``limg_tpu_torch/csrc`` to
``build/stamped/``, adds to its ``segment_encode_kernel`` a CTA barrier and
a ``clock64()`` stamp of thread 0 at the start of each phase (pixel counts,
channel sums, directions, factor extremes, endpoints and factors, crush
search, decode, end), builds ``segment_region.cu`` with nvcc and the
package's flags, and runs it once on the segment encode's inputs at P =
256, captured from a 4-level dense encode of the 4K test image
(``encode_image_merged(fused=False)``). It prints, over the CTAs that reach
the end, each phase's share of the summed CTA cycles and of the longest
CTA's, and checks the stamped build's outputs against the plain version.
The added barriers change the timing a little; the shares are what it is
for. Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("start", "pixel counts", "channel sums", "directions", "factor extremes",
          "endpoints and factors", "crush search", "decode and outputs")
# the phase comments of segment_encode_kernel a stamp goes before
MARKERS = ("  // ---- segment pixel counts", "  // ---- fit: channel sums -> avg",
           "  // ---- fit: the three directions", "  // ---- fit: factor extremes",
           "  // ---- fit: endpoints, factors", "  // ---- crush search",
           "  // ---- dither, decode and the outputs")
SLOTS = 16       # stamps a CTA
PIXELS = 256
TILE = 32        # segment starts a CTA takes at P = 256 (segment_encode.cuh seg_tile)
STAMP_DECL = "\n__device__ long long limg_stamps[1 << 21];\n"
READER = """
extern "C" int limg_read_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, limg_stamps, sizeof(long long) * n);
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
        if marker not in body:
            raise ValueError(f"no phase marker {marker.strip()!r}")
        body = body.replace(marker, stamp(k) + marker, 1)
    end = body.rindex("}")
    body = body[:end] + stamp(len(MARKERS) + 1) + body[end:]
    inc = '#include "limg_common.cuh"\n'
    if inc not in head:
        raise ValueError("no limg_common.cuh include in the source")
    return head.replace(inc, inc + STAMP_DECL, 1) + sep + body + sep2 + tail


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lane", choices=("rgb", "rgba"), default="rgb")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this tool needs a CUDA card")
    import limg_tpu_torch
    from chip_smoke import capture_coalesce_calls, compare_outputs, run_text
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.encoder import _as_image_tensor
    from limg_tpu_torch.kernels import build
    from limg_tpu_torch.kernels import coalesce as kc
    from limg_tpu_torch.kernels.encode_fixed import _CRUSH_MODES
    from tools.record_torch_reference import case_images

    device = torch.device("cuda", 0)
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                    "--format=csv,noheader"])
    print("card:", smi, flush=True)
    out_dir = ROOT / "build" / "stamped"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(ROOT / "limg_tpu_torch" / "csrc", out_dir)
    header = out_dir / "segment_encode.cuh"
    header.write_text(stamped_source(header.read_text()))
    entry = out_dir / "segment_region.cu"
    entry.write_text(entry.read_text() + READER)
    so = out_dir / "libsegment_region_stamped.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(out_dir / "segment_region.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.limg_segment_encode_region
    fn.argtypes = [ptr] * 4 + [i32] * 9 + [ctypes.c_uint32] + [ptr] * 11
    fn.restype = i32
    lib.limg_read_stamps.argtypes = [ptr, i32]

    img = case_images(2160, 3840)[args.lane]
    cfg = EncodeConfig(error_factor=100, has_alpha=args.lane == "rgba")
    img_d = _as_image_tensor(img, device)
    calls = capture_coalesce_calls(lambda: limg_tpu_torch.encode_image_merged(
        img_d, cfg, num_levels=4, fused=False, fetch_planes=False, device=device))
    (packed_c, mask_c, seg_c, blocks, cfg_c, key), kw = next(
        (a, kw) for a, kw in calls["segment_encode_kernel"] if a[0].shape[0] == PIXELS)
    p, n = packed_c.shape
    ch = cfg_c.channels

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    packed_bm, mask_bm = packed_c.t().contiguous(), mask_c.t().contiguous()
    f8 = empty(n, p)
    got = kc.SegmentEncode(shifts=empty(3, n), q=empty(n, p), dec=empty(n, p),
                           dist_blk=empty(n, dtype=torch.float32), count_blk=empty(n),
                           count_mem=empty(n), eps=empty(6, ch, n),
                           avg=empty(ch, n, dtype=torch.float32))
    rc = fn(packed_bm.data_ptr(), mask_bm.data_ptr(), seg_c.data_ptr(), blocks.data_ptr(), n, p,
            ch, _CRUSH_MODES.get(cfg_c.crush_mode, 1) if cfg_c.crush_bits else 0,
            int(cfg_c.dithering and cfg_c.crush_bits), cfg_c.ladder_k, cfg_c.num_factors,
            cfg_c.max_pixel_bit_crush_error, cfg_c.max_block_bit_crush_error, key, f8.data_ptr(),
            *(t.data_ptr() for t in got), None, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"stamped launch failed ({rc})")
    torch.cuda.synchronize(device)
    want = kc.segment_encode_reference(packed_c, mask_c, seg_c, blocks, cfg_c, key, **kw)
    compare_outputs(got._replace(q=None if want.q is None else got.q.t(), dec=got.dec.t()), want)
    grid = -(-n // TILE)
    host = np.zeros(grid * SLOTS, np.int64)
    if lib.limg_read_stamps(host.ctypes.data, host.size) != 0:
        raise SystemExit("reading the stamps failed")
    st = host.reshape(grid, SLOTS)[:, :len(PHASES) + 1]
    done = st[(st[:, -1] > 0) & (st[:, 0] > 0)]
    spans = np.diff(done, axis=1).astype(np.float64)
    total = spans.sum()
    longest = spans[spans.sum(1).argmax()]
    members = int(mask_c.any(dim=0).sum())
    print(f"4K {args.lane} segment_encode P={p}: {n} lanes ({members} with a member pixel), "
          f"{grid} CTAs, {len(done)} reach the end; cycles summed over them {total:.0f}, "
          f"the longest CTA {longest.sum():.0f} [{smi}]")
    for name, cyc, lng in zip(PHASES, spans.sum(0), longest):
        print(f"  {name:24s} {cyc / total:7.2%} of the summed cycles, {lng / longest.sum():7.2%} "
              f"of the longest CTA's ({lng:.0f})")
    print("stamped build bit-equal to the plain version")


if __name__ == "__main__":
    main()
