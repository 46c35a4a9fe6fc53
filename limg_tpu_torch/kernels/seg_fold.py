"""Scatter-form segment sum of float32 rows: the CUDA kernel's wrapper and
its plain version.

``seg_sum_fold_kernel`` is the card's route of ops/segments.py ``seg_sum``
for float32 rows; it replaces no Pallas kernel (the JAX package's
``seg_sum``, limg_tpu/ops/segments.py:44, is an XLA scatter-add).

    x (..., NB) float32, seg_id (NB,) ids in [0, S) -> (..., S) float32

Each segment's sum is a left fold over its members in block order,
starting from 0.0: what the JAX package's scatter-add gives on XLA:CPU and
``index_add_`` on the CPU, the plain version here. On a card ``index_add_``
adds with atomics, in an order that changes from run to run; the kernel
(``csrc/seg_fold.cu``) folds in block order, from a plan of the segment map
(``fold_plan``: the blocks stably sorted by segment id and each segment's
first slot), so it equals the plain version bit for bit, every run.

On a CUDA tensor the wrapper launches the kernel (built at first use) or
raises; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.segments import FoldPlan, fold_plan, seg_sum_plain

# kernel launches since the last reset (read and reset by callers)
launches = {"seg_sum_fold": 0}


def _check(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int, plan) -> None:
    if x.ndim < 1 or x.dtype != torch.float32:
        raise ValueError(f"x must be (..., NB) float32, got {tuple(x.shape)} {x.dtype}")
    nb = x.shape[-1]
    if seg_id.shape != (nb,) or seg_id.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"seg_id must be ({nb},) int32 or int64, got {tuple(seg_id.shape)} "
                         f"{seg_id.dtype}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if seg_id.device != x.device:
        raise ValueError(f"tensors on {x.device} and {seg_id.device}")
    if plan is not None:
        for name, t, n in (("order", plan.order, nb), ("starts", plan.starts, num_segments + 1)):
            if t.shape != (n,) or t.dtype != torch.int32 or t.device != x.device:
                raise ValueError(f"plan.{name} must be ({n},) int32 on {x.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")


def seg_sum_fold_reference(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int,
                           plan: FoldPlan | None = None) -> torch.Tensor:
    """Plain version of seg_sum_fold_kernel (``index_add_``; the plan is not
    needed)."""
    _check(x, seg_id, num_segments, plan)
    return seg_sum_plain(x, seg_id, num_segments)


@functools.cache
def _library():
    """The built kernel library, with its C signatures declared."""
    from .build import load_library

    lib = load_library("seg_fold")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.limg_seg_sum_fold.argtypes = [ptr] * 3 + [i32] * 3 + [ptr] * 2
    lib.limg_seg_sum_fold.restype = i32
    lib.limg_cuda_error_string.argtypes = [i32]
    lib.limg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def seg_sum_fold_kernel(x: torch.Tensor, seg_id: torch.Tensor, num_segments: int,
                        plan: FoldPlan | None = None) -> torch.Tensor:
    """Per-segment left-fold sums (..., S) of float32 rows (..., NB); see the
    module docstring. ``plan``: ``fold_plan(seg_id, num_segments)``, built
    here when None. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check(x, seg_id, num_segments, plan)
    dev = x.device
    if dev.type == "cpu":
        return seg_sum_fold_reference(x, seg_id, num_segments)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    plan = fold_plan(seg_id, num_segments) if plan is None else plan
    nb = x.shape[-1]
    rows = x.reshape(-1, nb).contiguous()
    out = torch.empty((rows.shape[0], num_segments), dtype=torch.float32, device=dev)
    if out.numel():
        order, starts = plan.order.contiguous(), plan.starts.contiguous()
        with torch.cuda.device(dev):
            lib = _library()
            rc = lib.limg_seg_sum_fold(rows.data_ptr(), order.data_ptr(), starts.data_ptr(),
                                       rows.shape[0], nb, num_segments, out.data_ptr(),
                                       torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"seg_sum_fold kernel launch failed: "
                               f"{lib.limg_cuda_error_string(rc).decode()} ({rc})")
        launches["seg_sum_fold"] += 1
    return out.reshape(*x.shape[:-1], num_segments)
