"""Observability: culprit-style diagnostics, spans and counters, and a profiler hook.

The counterpart of ``limg_tpu/utils/diagnostics.py``, with the same counts
and the same printout. The reference counts every rejection path into named
"culprit" counters (src/limg_internal.h:180-192) and prints a breakdown in
debug builds (src/limg.cpp:2412-2428). The batched encoder has no early
exits to count, so the equivalent question -- "what stops each block from
crushing further?" -- is answered directly: for the chosen shift triple,
try incrementing each axis and classify which admissibility constraint
binds. The counts are deterministic reductions.

Spans and counters: the encode paths mark each stage with ``span(name)``
(a ``torch.profiler.record_function`` while a profiler records, so the
stages land in the profiler's trace beside the device operations they
launch, on one clock) and report work counts with ``count(name, value)``,
kept by every ``record_counts()`` open around the call. Both are free when
nothing listens: no record_function, no host sync, no launch.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import tempfile

import numpy as np
import torch

from ..config import EncodeConfig


def crush_culprits(px_u8, mask, f8_u8, decomp, shifts, cfg: EncodeConfig):
    """Classify what binds each block at its chosen shifts.

    ``px_u8`` (>= ch, P, NB) uint8, ``mask`` (P, NB), ``f8_u8`` the three
    (P, NB) uint8 factor planes, ``decomp`` their Decomposition and
    ``shifts`` (3, NB) int32, all on one device. Returns a dict of counts
    over blocks:

    - pixel_bound:  incrementing any axis violates maxPixelBitCrushError
                    (the culpritWasPixelBitCrushError analog)
    - block_bound:  incrementing violates only the block-mean error
                    (culpritWasBlockBitCrushError analog)
    - saturated:    all axes already at the drop encoding (s == 8)
    - expandable:   some single-axis increment would still be admissible
                    (the greedy reference search would have taken it; for the
                    ladder mode this measures ranking-model misses)
    """
    from ..ops.crush import _admissible, err_scale_shift, evaluate_batch

    ch = cfg.channels
    px = px_u8[:ch].to(torch.int32)
    mask_i = mask.to(torch.int32)
    count = mask_i.sum(dim=0, dtype=torch.int32)
    f8 = torch.stack([p.to(torch.int32) for p in f8_u8])
    shifts = shifts.to(torch.int32)
    # regions of 2048 pixels or more pre-scale the block error; the
    # admissibility test compensates identically (ops/crush.py)
    es = err_scale_shift(px.shape[1])

    nb = shifts.shape[-1]
    sat = (shifts >= 8).all(dim=0)
    any_pixel = torch.zeros(nb, dtype=torch.bool, device=px.device)
    any_block = torch.zeros_like(any_pixel)
    any_ok = torch.zeros_like(any_pixel)
    for axis in range(3):
        bump = shifts.clone()
        bump[axis] += 1
        bump = torch.clamp(bump, max=8)
        valid = shifts[axis] < 8
        pix_max, block_err = evaluate_batch(px, mask_i, f8, decomp, bump[None], ch, es)
        pix_max, block_err = pix_max[0], block_err[0]
        ok = _admissible(pix_max, block_err, count, cfg, None, es) & valid
        pix_fail = (pix_max > cfg.max_pixel_bit_crush_error) & valid
        # the pixel test passed but admissibility failed => block error binds
        blk_fail = ~ok & ~pix_fail & valid
        any_pixel |= pix_fail
        any_block |= blk_fail
        any_ok |= ok

    return {
        "blocks": int(nb),
        "saturated": int(sat.sum()),
        "pixel_bound": int((any_pixel & ~any_ok & ~sat).sum()),
        "block_bound": int((any_block & ~any_pixel & ~any_ok & ~sat).sum()),
        "expandable": int(any_ok.sum()),
    }


def crush_culprits_merged(image, state, cfg: EncodeConfig, device="cuda"):
    """Culprits of the merged encode that actually ran, at region granularity.

    ``state`` is the serializer state of either package's
    ``encode_image_merged(..., return_state=True)`` -- the owner-level
    shifts/endpoints/crushed factors of the real encode. Bumping axis k of a
    region from s to s+1 re-crushes as q >> 1, which is EXACTLY the encode's
    own dithered factor crushed at s+1 (q = (f8 + noise) >> s, so
    q >> 1 = (f8 + noise) >> (s+1)); the reported bounds are therefore those
    of the encode itself, not of a fixed-grid re-encode
    (reference semantics: src/limg.cpp:2412-2428 prints the culprits of the
    encode it ran).

    The three bumped decodes and each block's error sum and maximum run on
    the image's device (``device`` when ``image`` is a NumPy array); the
    per-segment sums run on the host in float64."""
    from ..bitstream import _host, _lead_levels, _segments_of
    from ..encoder import _as_image_tensor, resolve_device
    from ..ops import layout
    from ..ops.decode import decode_blocks
    from ..ops.error import weighted_error
    from ..ops.fit import Decomposition

    ch = cfg.channels
    dev = image.device if isinstance(image, torch.Tensor) else resolve_device(device)
    px_full, mask, grid = layout.blockify(_as_image_tensor(image, dev))
    px = px_full[:ch].to(torch.int32)
    mask_i = mask.to(torch.int32)

    rows = _host(state["rows"])
    nb = rows.shape[-1]
    owner0 = rows[0].astype(np.int64)
    shifts = np.minimum(rows[1:4], 8).astype(np.int32)           # (3, NB)
    eps = rows[4:4 + 6 * ch].astype(np.int32)
    run_seg = rows[4 + 6 * ch].astype(np.int64)
    run_applied = rows[5 + 6 * ch].astype(bool)
    lead = _lead_levels(owner0, grid.blocks_y, grid.blocks_x, state["num_levels"])
    lead[run_applied] = run_seg[run_applied]
    keys, inv, order = _segments_of(owner0, lead, nb)
    nseg = keys.size

    e = [torch.from_numpy(eps[j * ch:(j + 1) * ch]).to(dev) for j in range(6)]
    d = Decomposition(
        avg=torch.zeros((ch, nb), dtype=torch.float32, device=dev),
        dirA_min=e[0], dirA_max=e[1], dirB_offset=e[2], dirB_mag=e[3],
        dirC_offset=e[4], dirC_mag=e[5],
    )
    q_arr = torch.as_tensor(_host(state["q"])).to(dev)
    if q_arr.ndim == 3:
        # (3, P, NB) u8 axis planes (fused-path serializer state)
        q = q_arr.to(torch.int32)
    else:
        q = torch.stack([(q_arr >> (8 * k)) & 0xFF for k in range(3)])
    shifts_t = torch.from_numpy(shifts).to(dev)

    # per-axis bump: exact per-block error sums and maxima, aggregated per
    # region on the host
    seg_blk = inv[order]                                         # sorted
    starts = np.flatnonzero(np.r_[True, seg_blk[1:] != seg_blk[:-1]])
    count_px = mask_i.sum(dim=0).cpu().numpy()
    seg_count = np.bincount(inv, weights=count_px, minlength=nseg)
    s_hdr = shifts[:, (keys % nb).astype(np.int64)]              # (3, nseg)
    sat = (s_hdr >= 8).all(axis=0)
    any_pixel = np.zeros(nseg, bool)
    any_block = np.zeros(nseg, bool)
    any_ok = np.zeros(nseg, bool)
    for axis in range(3):
        bump = shifts_t.clone()
        bump[axis] += 1
        bump = torch.clamp(bump, max=8)
        q_b = q.clone()
        q_b[axis] = q[axis] >> 1
        dec = decode_blocks(q_b, bump, d, ch)
        # per-pixel weighted errors fit int32 (max 780300); a block's sum is
        # exact in int64, then float64 on the host
        err = weighted_error(dec, px) * mask_i                   # (P, NB)
        blk_sum = err.sum(dim=0, dtype=torch.int64).cpu().numpy().astype(np.float64)
        blk_max = err.amax(dim=0).cpu().numpy()
        seg_sum = np.bincount(inv, weights=blk_sum, minlength=nseg)
        seg_max = np.maximum.reduceat(blk_max[order], starts)
        valid = s_hdr[axis] < 8
        pix_fail = (seg_max > cfg.max_pixel_bit_crush_error) & valid
        ok = (~pix_fail
              & (seg_sum * 0x10 < cfg.max_block_bit_crush_error * seg_count)
              & valid)
        any_pixel |= pix_fail
        any_block |= ~ok & ~pix_fail & valid
        any_ok |= ok

    return {
        "blocks": int(nseg),
        "saturated": int(sat.sum()),
        "pixel_bound": int((any_pixel & ~any_ok & ~sat).sum()),
        "block_bound": int((any_block & ~any_pixel & ~any_ok & ~sat).sum()),
        "expandable": int(any_ok.sum()),
    }


def format_culprits(crush: dict, merge_stats=None, coalesce_stats=None) -> str:
    """Reference-style breakdown printout (src/limg.cpp:2412-2428)."""
    lines = ["CULPRIT info:", "-- Bit Crush -----------------------------------------"]
    total = max(1, crush["blocks"])
    for k in ("pixel_bound", "block_bound", "saturated", "expandable"):
        lines.append(
            "%-22s: %8d (%7.3f%%)" % (k, crush[k], crush[k] / total * 100.0)
        )
    if merge_stats:
        lines.append("-- Block Merge ---------------------------------------")
        for lvl, s in enumerate(merge_stats):
            for k, v in s.items():
                lines.append("L%d %-19s: %10g" % (lvl + 1, k, float(v)))
    if coalesce_stats:
        # capacity truncation must be visible, never silent
        lines.append("-- Coalescing ----------------------------------------")
        for k, v in coalesce_stats.items():
            lines.append("%-22s: %10d" % (k, int(v)))
    return "\n".join(lines)


# the recordings open in this context, innermost last
_RECORDINGS: contextvars.ContextVar = contextvars.ContextVar("limg_recordings", default=())
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one stage of an encode: while a
    ``torch.profiler`` records, ``record_function(name)``; otherwise one
    shared no-op object (``record_function`` costs microseconds a call even
    with the profiler off)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, value) -> None:
    """Append ``value`` (a host int, or a 0-d device tensor the program
    never reads) to ``name`` in every open ``record_counts()``; nothing
    when none is open."""
    for rec in _RECORDINGS.get():
        rec.values.setdefault(name, []).append(value)


class Recording:
    """The counts of one ``record_counts()``: ``values`` maps a counter's
    name to its values in call order, device tensors left on their device
    until ``drain``."""

    def __init__(self):
        self.values: dict = {}

    def drain(self) -> dict:
        """{name: [int, ...]}: every device value copied to the host in one
        transfer a device (a stack, then one copy), host ints as they are."""
        by_device: dict = {}
        for vals in self.values.values():
            for i, v in enumerate(vals):
                if isinstance(v, torch.Tensor):
                    by_device.setdefault(v.device, []).append((vals, i))
        for refs in by_device.values():
            host = torch.stack([vals[i].reshape(()) for vals, i in refs]).tolist()
            for (vals, i), h in zip(refs, host):
                vals[i] = h
        return {name: [int(v) for v in vals] for name, vals in self.values.items()}


@contextlib.contextmanager
def record_counts():
    """Collect the ``count`` calls made inside the block into the yielded
    ``Recording``; read them after the block with ``drain()``, outside the
    timed work."""
    rec = Recording()
    token = _RECORDINGS.set(_RECORDINGS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDINGS.reset(token)


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """torch.profiler context (CPU, and CUDA where there is a card) that
    writes a chrome trace, ``trace.json``, with the encode's spans, and the
    counts of the block, ``counters.json`` ({name: [values]}), into
    ``log_dir`` (default: a directory under the temporary directory) -- the
    JAX package's jax.profiler hook (reference kept IACA markers at
    src/iacaMarks.h:35-36)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "limg_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with record_counts() as rec, profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(rec.drain(), f)
