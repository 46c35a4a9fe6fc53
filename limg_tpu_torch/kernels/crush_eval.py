"""Segment crush evaluation: the CUDA kernel's wrapper and its plain version.

``crush_eval_rows_kernel`` takes the role of the JAX package's
``crush_eval_rows_pallas`` (limg_tpu/pallas_kernels/encode_fixed.py:1021,
one triple per block: K = 1) and ``crush_eval_rows_k_pallas`` (:1063, K
triples per block), one kernel body (``_make_eval_kernel`` :964): the
decode simulation of the crush search, each block's exact pixel maximum and
error sum for K candidate shift triples.

    packed, mask, f8_packed (P, N) int32 (P <= MAX_PIXELS; mask 0 / 1),
    eps (6, ch, N) int32 endpoint rows (dirA_min, dirA_max, dirB_offset,
    dirB_mag, dirC_offset, dirC_mag), cands (K, 3, N) int32 shifts
    -> pm, be (K, N) int32

``be`` sums the errors with no pre-scale (the JAX package's err-scale 0).
The run-coalescing re-encode composed of plain ops
(``regions.coalesce_segments(use_kernel=False)``) evaluates its candidates
here, through ``ops/crush.find_shifts(use_kernel=True)``; the search asks
for at most 81 candidates a call (the exhaustive mode's chunk), so the
(K, N) outputs stay small beside the (P, N) inputs.

On a CUDA tensor the wrapper launches ``csrc/crush_eval.cu`` (built at
first use) or raises; on a CPU tensor it runs the plain version,
``ops/crush.evaluate_batch``, which is bit-exact against the JAX package's
``evaluate_shifts``. The sums are of integers, so the two agree bit for bit
whatever their order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.crush import evaluate_batch
from ..ops.fit import Decomposition
from ..ops.layout import unpack_plane

# kernel launches since the last reset (read and reset by callers)
launches = {"crush_eval_rows": 0}

# the block sizes the kernel takes: 8x8 blocks and 16x16 regions, the JAX
# kernel's limit (limg_tpu/ops/segments.py:402-403)
PIXEL_SIZES = (64, 256)
MAX_PIXELS = max(PIXEL_SIZES)


def pack_words(planes: torch.Tensor) -> torch.Tensor:
    """(n <= 4, P, N) int32 bytes -> (P, N) int32 words, plane c in byte c."""
    words = planes[0]
    for c in range(1, planes.shape[0]):
        words = words | (planes[c] << (8 * c))
    return words


def _check(packed, mask, f8_packed, eps, cands, channels: int) -> None:
    if packed.ndim != 2 or packed.shape[0] not in PIXEL_SIZES:
        raise ValueError(f"packed must be (P, N), P in {PIXEL_SIZES}, got {tuple(packed.shape)}")
    p, n = packed.shape
    for name, t, shape in (("packed", packed, (p, n)), ("mask", mask, (p, n)),
                           ("f8_packed", f8_packed, (p, n)), ("eps", eps, (6, channels, n))):
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be {shape} int32, got {tuple(t.shape)} {t.dtype}")
    if cands.ndim != 3 or cands.shape[1:] != (3, n) or cands.dtype != torch.int32:
        raise ValueError(f"cands must be (K, 3, {n}) int32, got {tuple(cands.shape)} {cands.dtype}")
    for t in (mask, f8_packed, eps, cands):
        if t.device != packed.device:
            raise ValueError(f"tensors on {packed.device} and {t.device}")


def crush_eval_rows_reference(packed, mask, f8_packed, eps, cands, channels: int):
    """Plain version of crush_eval_rows_kernel."""
    _check(packed, mask, f8_packed, eps, cands, channels)
    px = torch.stack([unpack_plane(packed, c) for c in range(channels)])
    f8 = torch.stack([unpack_plane(f8_packed, k) for k in range(3)])
    avg = torch.zeros(eps.shape[1:], dtype=torch.float32, device=eps.device)   # unused by decode
    return evaluate_batch(px, mask, f8, Decomposition(avg, *eps.unbind(0)), cands, channels)


@functools.cache
def _library():
    """The built kernel library, with its C signatures declared."""
    from .build import load_library

    lib = load_library("crush_eval")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.limg_crush_eval.argtypes = [ptr] * 5 + [i32] * 4 + [ptr] * 3
    lib.limg_crush_eval.restype = i32
    lib.limg_cuda_error_string.argtypes = [i32]
    lib.limg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def crush_eval_rows_kernel(packed, mask, f8_packed, eps, cands, channels: int):
    """Per-block (pixel max, error sum) of K candidate shift triples; see the
    module docstring. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check(packed, mask, f8_packed, eps, cands, channels)
    dev = packed.device
    if dev.type == "cpu":
        return crush_eval_rows_reference(packed, mask, f8_packed, eps, cands, channels)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    (p, n), k = packed.shape, cands.shape[0]
    pm = torch.empty((k, n), dtype=torch.int32, device=dev)
    be = torch.empty((k, n), dtype=torch.int32, device=dev)
    if k == 0 or n == 0:
        return pm, be
    ins = [t.contiguous() for t in (packed, mask, f8_packed, eps, cands)]
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.limg_crush_eval(*(t.data_ptr() for t in ins), p, n, k, channels,
                                 pm.data_ptr(), be.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crush_eval_rows kernel launch failed: "
                           f"{lib.limg_cuda_error_string(rc).decode()} ({rc})")
    launches["crush_eval_rows"] += 1
    return pm, be
