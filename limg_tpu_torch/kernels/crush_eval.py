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

Most of the search's calls give every block the same triples: a (K, 3)
table expanded over the blocks with stride 0 (``ops/crush._const_cands``:
the ladder's 27 axis sweeps, an exhaustive chunk of 81, the guess mode's 4,
the floors' (0, 0, 0)). The wrapper reads such a table to the host (324
bytes for the sweeps; the table was just copied from the host, so the
stream has little to drain) and hands the kernel an evaluation plan,
``eval_plan``, instead of a copy of the table per block: each distinct
triple once, grouped so that a group's triples differ in one axis only,
whose decode is all the kernel redoes within the group. Per-block triples
(the ladder's verified candidates) go to the kernel as they are.

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
from . import launch

# the block sizes the kernel takes: 8x8 blocks and 16x16 regions, the JAX
# kernel's limit (limg_tpu/ops/segments.py:402-403)
PIXEL_SIZES = (64, 256)
MAX_PIXELS = max(PIXEL_SIZES)
# a plan's table rows per launch (csrc/crush_eval.cu kMaxSteps): a longer
# table goes in several launches
MAX_STEPS = 128
_REBASE = 1 << 14


def table_of(cands: torch.Tensor):
    """The (K, 3) table of ``cands`` (K, 3, N) when it repeats one column over
    every block with stride 0, as ``ops/crush._const_cands`` expands it; else
    None."""
    if cands.shape[2] > 1 and cands.stride(2) == 0:
        return cands[:, :, 0]
    return None


@functools.lru_cache(maxsize=64)
def eval_plan(rows: tuple) -> tuple[tuple, tuple]:
    """The kernel's evaluation plan of a table of shift triples.

    ``rows``: K triples (a tuple of 3-tuples of ints >= 0; a shift above 8
    decodes as 8 and is read as 8). Returns (steps, outs): ``steps`` the
    distinct triples, each once, as (triple, inner axis, rebase) in
    evaluation order; ``outs[r]`` the step whose values row r takes.

    The triples go in groups that share the shifts of two axes, the inner
    axis varying, ascending, within the group; the first step of a group
    rebases (decodes the two other axes), the others decode the inner axis
    alone. Groups are taken largest first (ties to the higher inner axis,
    then the smaller shared shifts): the 27 axis sweeps are three groups
    (axis 2, 1, then 0; (0, 0, 0) once), an exhaustive chunk of axis 0 at
    one shift nine groups of 9 along axis 2, in ascending axis-1 shift.
    """
    canon = []
    for t in rows:
        if len(t) != 3 or min(t) < 0:
            raise ValueError(f"a table row is 3 shifts >= 0, got {t}")
        canon.append(tuple(min(int(s), 8) for s in t))
    left = set(canon)
    steps = []
    while left:
        groups = {}
        for t in left:
            for a in range(3):
                groups.setdefault((a, t[:a] + t[a + 1:]), []).append(t)
        (a, _), members = max(groups.items(), key=lambda g: (len(g[1]), g[0][0],
                                                             tuple(-s for s in g[0][1])))
        for i, t in enumerate(sorted(members, key=lambda t: t[a])):
            steps.append((t, a, i == 0))
        left.difference_update(members)
    index = {t: i for i, (t, _, _) in enumerate(steps)}
    return tuple(steps), tuple(index[t] for t in canon)


def pack_plan(steps, outs) -> list[int]:
    """A plan as the C entry point reads it: n_steps, n_out, one word per
    step (s0 | s1 << 4 | s2 << 8 | inner << 12 | rebase << 14), then outs."""
    words = [t[0] | (t[1] << 4) | (t[2] << 8) | (a << 12) | (_REBASE if rebase else 0)
             for t, a, rebase in steps]
    return [len(steps), len(outs), *words, *outs]


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


def crush_eval_rows_kernel(packed, mask, f8_packed, eps, cands, channels: int):
    """Per-block (pixel max, error sum) of K candidate shift triples; see the
    module docstring. A CPU tensor goes to the plain version; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check(packed, mask, f8_packed, eps, cands, channels)
    dev = packed.device
    if not launch.on_card(dev):
        return crush_eval_rows_reference(packed, mask, f8_packed, eps, cands, channels)
    (p, n), k = packed.shape, cands.shape[0]
    pm = torch.empty((k, n), dtype=torch.int32, device=dev)
    be = torch.empty((k, n), dtype=torch.int32, device=dev)
    if k == 0 or n == 0:
        return pm, be
    lib = launch.library("crush_eval")
    ins = [t.contiguous() for t in (packed, mask, f8_packed, eps)]
    table = table_of(cands)
    # one launch for per-block triples, one per MAX_STEPS rows of a table
    if table is None:
        calls = [(cands.contiguous(), None, 0, k)]
    else:
        rows = tuple(map(tuple, table.cpu().tolist()))
        calls = [(None, pack_plan(*eval_plan(rows[r0:r0 + MAX_STEPS])), r0,
                  min(MAX_STEPS, k - r0)) for r0 in range(0, k, MAX_STEPS)]
    for per_block, plan, r0, rows_k in calls:
        words = None if plan is None else (ctypes.c_int32 * len(plan))(*plan)
        launch.call(lib, "limg_crush_eval", "crush_eval_rows", dev,
                    *(t.data_ptr() for t in ins),
                    None if per_block is None else per_block.data_ptr(),
                    None if words is None else ctypes.addressof(words),
                    p, n, rows_k, channels, pm[r0:].data_ptr(), be[r0:].data_ptr())
    return pm, be
