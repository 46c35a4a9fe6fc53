"""Peaks of the card and work per pixel, copied from ``chip_smoke.py``.

The bound of a call is the larger of its bytes over the HBM rate and its
operations over the scalar rate, from NVIDIA's H100 SXM data sheet (3.35
TB/s; 67 TFLOP/s float32 outside the tensor cores). The port's kernels do
32-bit integer and float scalar work outside the tensor cores, all of it
counted at the float32 rate (Hopper issues int32 at half of it, so shares
are understated, never overstated).
"""

from __future__ import annotations

from dataclasses import dataclass, field

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BLOCK = 8
BLOCK_AREA = BLOCK * BLOCK
I32 = 4


@dataclass(frozen=True)
class Job:
    """One call's encode as the counts see it: the frame size and the
    number of frames (1 for an image, B for a batch of B frames of one
    size), the encode configuration (``reference.EncodeConfig``), the
    entry's levels and the content's counts (``entries/<entry>.run_members``,
    over the whole call)."""

    height: int
    width: int
    cfg: object
    num_levels: int = 1
    members: dict = field(default_factory=dict)
    frames: int = 1

    @property
    def pixels(self) -> int:
        """Every pixel of the call's frames."""
        return self.frames * self.height * self.width

    def blocks(self, lvl: int = 0) -> int:
        """Regions of 8 * 2^lvl pixels a side covering the call's frames,
        each frame's edges padded alone."""
        side = BLOCK << lvl
        return self.frames * -(-self.height // side) * -(-self.width // side)


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
    sweeps share the three axes' decode at shift 0 (and their per-axis
    sums, a channel add each), so each of the 24 others decodes one axis;
    every sweep prices its error; then ``ladder_k`` full candidates.
    Exhaustive: the 729 triples. Guess: the four canned triples and (0, 0,
    0) for the floors."""
    if not cfg.crush_bits or cfg.crush_mode == "none":
        return 0
    ch = cfg.channels
    if cfg.crush_mode == "ladder":
        sweeps = (3 * axis_decode_ops(ch) + 3 * ch + 24 * axis_decode_ops(ch)
                  + 25 * pixel_err_ops(ch))
        return sweeps + cfg.ladder_k * eval_ops(ch)
    n = {"exhaustive": 729, "guess": 4 + (1 if cfg.num_factors < 3 else 0)}[cfg.crush_mode]
    return n * eval_ops(ch)


def encode_ops(pixels: int, searched: int, cfg) -> int:
    """A full encode of ``pixels`` pixels, ``searched`` of them members of
    the regions the crush search evaluates."""
    ch = cfg.channels
    return pixels * (fit_ops(ch) + finish_ops(ch)) + searched * search_ops(cfg)


def call_bound(ops: int, nbytes: int) -> tuple:
    """(bound s, "bytes" or "operations") of a call."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def region_encode_bound(job: Job, lvl: int) -> tuple:
    """The region encode of every level-``lvl`` region (P = 64 * 4^lvl
    pixels, edge regions zero-padded) with its endpoints: read the words and
    the mask once; write shifts, crushed and decoded words, the error, the
    six endpoint rows and the means."""
    p, nb, ch = BLOCK_AREA << 2 * lvl, job.blocks(lvl), job.cfg.channels
    nbytes = (p * nb * (I32 + 1)                                # words, mask
              + nb * (3 * I32 + 2 * p * I32 + I32 + 6 * ch * I32 + ch * I32))
    return call_bound(encode_ops(p * nb, p * nb, job.cfg), nbytes)
