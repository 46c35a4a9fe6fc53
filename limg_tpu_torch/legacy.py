"""Legacy 1-factor encoder: the counterpart of ``limg_tpu/legacy.py``, the
reference's limg_encode_test (src/limg.cpp:889-1086).

One colour axis A -> B per region, one u8 factor plane, a shift search
that takes the largest prefix of passing shifts 1..7
(src/limg_bit_crush.h:68-94), and a 1-factor decode that keeps the
reference's mod-256 wrap (src/limg_decode.h:6-34). Regions are aligned
power-of-two squares decided by a quadtree: a parent is alive when its four
children are and its own 2-point refit passes the per-pixel and per-block
error checks (src/limg_factorization.h:217-380). Level-0 blocks that fail
their own fit are uncovered and keep the source pixels
(src/limg.cpp:1072-1074), and with ``pixel_grow`` three rounds of 2-pixel
steps in four directions let uncovered pixels next to a region join it on
its line (src/limg.cpp:508-796).

The JAX package runs this in plain jnp, with no Pallas kernel, so the port
runs it in plain PyTorch on any device; the growth's ``lax.scan`` /
``lax.switch`` over 3 rounds x 4 directions is a Python loop. Float sums
over a region's pixels are the halving tree of ops/fit.py and sums over
channels left folds; the JAX package sums in XLA's order, so a rounded
endpoint or factor can differ from it by 1 on a few regions. Dithering
draws from the port's hash (ops/dither.py), level l keyed by
``level_key(seed, 0, l)``; the JAX package's threefry bits differ, so
parity with it is statistical only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import BLOCK_SIZE
from .encoder import _as_image_tensor, resolve_device
from .ops import layout
from .ops.dither import dither_crush_key, level_key
from .ops.error import max_possible_error, weighted_error
from .ops.fit import _signed_unit_mean, channel_dot, inv_or_zero, tree_sum
from .ops.reduce import BlockReducer
from .regions import _child_indices, _owner_level

_BIG = 3.4e38


@dataclasses.dataclass(frozen=True)
class LegacyConfig:
    """limg_encode_test thresholds (src/limg.cpp:902-934)."""

    error_factor: int = 100
    has_alpha: bool = False
    dithering: bool = True
    # pixel-granular boundary growth (the reference's step-of-2 region grow,
    # src/limg.cpp:508-796); False keeps block-aligned coverage only
    pixel_grow: bool = True

    @property
    def channels(self) -> int:
        return 4 if self.has_alpha else 3

    @property
    def max_pixel_block_error(self) -> int:
        return 0x12 * self.error_factor * (6 if self.has_alpha else 4)

    @property
    def max_block_pixel_error(self) -> int:
        return 0x1C * (self.error_factor // 3) * (6 if self.has_alpha else 4)

    @property
    def max_pixel_bit_crush_error(self) -> int:
        return 0x5 * (self.error_factor // 2) * (10 if self.has_alpha else 7)

    @property
    def max_block_bit_crush_error(self) -> int:
        return 0x2 * (self.error_factor // 2) * (10 if self.has_alpha else 7)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the low 32 bits (the JAX package's int32 wrap)."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def _weighted_err_vec(err_vec: torch.Tensor, px: torch.Tensor, channels: int) -> torch.Tensor:
    """limg_color_error_from_error_vec_ (src/limg_internal.h:577-634): the
    float error vector's weighted square, weights chosen by the pixel's own
    red < 0x80, summed as a left fold over channels."""
    red_lo = px[0] < 128.0
    w = (torch.where(red_lo, 2.0, 3.0), 4.0, torch.where(red_lo, 3.0, 2.0), 3.0)
    err = err_vec[0] * err_vec[0] * w[0]
    for c in range(1, channels):
        err = err + err_vec[c] * err_vec[c] * w[c]
    return err


def fit_2pt(px_u8: torch.Tensor, mask: torch.Tensor, cfg: LegacyConfig):
    """Batched 2-point (A axis) fit of each region with its acceptance
    checks (limg_tpu/legacy.py:86). ``px_u8``: (>=ch, P, NB); ``mask``: (P,
    NB) bool. Returns (a, b endpoints (ch, NB) int32 in [0, 255], factors
    against the rounded endpoints (P, NB) float32, accepted (NB,) bool,
    block error (NB,) float32)."""
    ch = cfg.channels
    px = px_u8[:ch].to(torch.float32)
    m = mask.to(torch.float32)
    count = mask.sum(dim=0, dtype=torch.int32).to(torch.float32)
    inv_count = 1.0 / torch.clamp(count, min=1.0)

    avg = tree_sum(px * m, 1) * inv_count
    corrected = (px - avg[:, None, :]) * m
    dir_a = _signed_unit_mean(corrected, m, inv_count, BlockReducer())
    fac = channel_dot(corrected, dir_a[:, None, :]) * inv_or_zero(channel_dot(dir_a, dir_a)) * m

    est = avg[:, None, :] + fac[None] * dir_a[:, None, :]
    pix_err = _weighted_err_vec((px - est) * m, px, ch)
    pix_ok = (pix_err <= cfg.max_pixel_block_error) | ~mask
    block_err = tree_sum(pix_err, 0)
    accepted = pix_ok.all(dim=0) & (block_err * 16.0 < float(cfg.max_block_pixel_error) * count)

    mn = torch.where(mask, fac, _BIG).amin(dim=0)
    mx = torch.where(mask, fac, -_BIG).amax(dim=0)
    a = torch.clamp(torch.floor(avg + mn * dir_a + 0.5), 0, 255).to(torch.int32)
    b = torch.clamp(torch.floor(avg + mx * dir_a + 0.5), 0, 255).to(torch.int32)

    # factors against the rounded endpoints (limg_encode_check_area's
    # write-factors pass reprojects onto a..b, src/limg.cpp:10-110)
    nrm = (b - a).to(torch.float32)
    fac_ab = (channel_dot(px - a.to(torch.float32)[:, None, :], nrm[:, None, :])
              * inv_or_zero(channel_dot(nrm, nrm)))
    return a, b, fac_ab, accepted, block_err


def decode_1d(q: torch.Tensor, shift: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              channels: int) -> torch.Tensor:
    """Mod-256 1-factor decode. ``q``: (P, NB) crushed factors; ``shift``:
    (NB,); ``a`` / ``b``: (ch, NB) int32. Returns (ch, P, NB) int32 in
    [0, 255]: (a + ((q << s) * (b - a) + 128 >> 8)) & 0xFF, which wraps
    where b < a instead of clamping."""
    prod = (q << shift[None])[None] * (b - a)[:, None, :] + 128
    return (a[:, None, :] + (prod >> 8)) & 0xFF


def find_shift_1d(px_u8: torch.Tensor, mask: torch.Tensor, f8: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, cfg: LegacyConfig) -> torch.Tensor:
    """The largest prefix of shifts 1..7 that pass the crush checks, per
    region (limg_tpu/legacy.py:147): the pixel max and the block error sum
    * 16 (both int32 with wrap-around) against the thresholds. Returns
    (NB,) int32 in [0, 7]."""
    ch = cfg.channels
    px = px_u8[:ch].to(torch.int32)
    mask_i = mask.to(torch.int32)
    count = mask_i.sum(dim=0, dtype=torch.int32)
    limit = _wrap32(count.to(torch.int64) * cfg.max_block_bit_crush_error)
    passed = torch.ones_like(count, dtype=torch.bool)
    shift = torch.zeros_like(count)
    for s in range(1, 8):
        dec = decode_1d(f8 >> s, torch.full_like(count, s), a, b, ch)
        err = weighted_error(dec, px) * mask_i
        blk = _wrap32(err.sum(dim=0, dtype=torch.int64) * 0x10)
        passed = passed & (err.amax(dim=0) <= cfg.max_pixel_bit_crush_error) & (blk < limit)
        shift = shift + passed.to(torch.int32)
    return shift


def _shift2(x: torch.Tensor, d: int) -> torch.Tensor:
    """A (..., H, W) plane moved 2 px: each pixel takes the value 2 px below
    (d = 0), above (1), right (2) or left (3) of it, 0 past the edge."""
    out = torch.zeros_like(x)
    if d == 0:
        out[..., :-2, :] = x[..., 2:, :]
    elif d == 1:
        out[..., 2:, :] = x[..., :-2, :]
    elif d == 2:
        out[..., :, :-2] = x[..., :, 2:]
    else:
        out[..., :, 2:] = x[..., :, :-2]
    return out


def _grow(src: torch.Tensor, covered, dec, a_pl, b_pl, shift_pl, factors, cfg: LegacyConfig):
    """Pixel-granular boundary growth (limg_tpu/legacy.py:270-334): 3 rounds
    of the 4 directions; an uncovered pixel 2 px from a covered one borrows
    its region's line (a, b, shift), reprojects its own colour, crushes at
    that shift, and joins when the decode's pixel error passes
    maxPixelBitCrushError. ``src``: (ch, H, W) int32; ``dec``, ``a_pl``,
    ``b_pl``: (ch, H, W) int32; ``covered``, ``shift_pl``, ``factors``: (H,
    W). Returns them updated and the count of grown pixels."""
    ch = cfg.channels
    grown = torch.zeros((), dtype=torch.int64, device=src.device)
    for _ in range(3):
        for d in range(4):
            stack = _shift2(torch.cat([covered[None].to(torch.int32), shift_pl[None], a_pl, b_pl]),
                            d)
            s_s, a_s, b_s = stack[1], stack[2:2 + ch], stack[2 + ch:]
            cand = (stack[0] > 0) & ~covered
            nrm = (b_s - a_s).to(torch.float32)
            fac = (channel_dot(src.to(torch.float32) - a_s.to(torch.float32), nrm)
                   * inv_or_zero(channel_dot(nrm, nrm)))
            f8 = torch.clamp(torch.floor(fac * 255.0 + 0.5), 0, 255).to(torch.int32)
            q = f8 >> s_s
            dec_d = (a_s + (((q << s_s)[None] * (b_s - a_s) + 128) >> 8)) & 0xFF
            ok = cand & (weighted_error(dec_d, src) <= cfg.max_pixel_bit_crush_error)
            covered = covered | ok
            grown = grown + ok.sum()
            dec = torch.where(ok[None], dec_d, dec)
            a_pl = torch.where(ok[None], a_s, a_pl)
            b_pl = torch.where(ok[None], b_s, b_pl)
            shift_pl = torch.where(ok, s_s, shift_pl)
            factors = torch.where(ok, (q << s_s) & 0xFF, factors)
    return covered, dec, a_pl, b_pl, shift_pl, factors, grown


def encode_legacy_device(image: torch.Tensor, cfg: LegacyConfig, seed: int = 0,
                         num_levels: int = 3):
    """The legacy encode of an (H, W, 3|4) uint8 tensor on its device
    (limg_tpu/legacy.py:173). Returns (decoded (H, W, 4) uint8, factors (H,
    W) uint8, a and b planes (ch, H, W) int32, shift plane (H, W) int32,
    covered (H, W) bool, stats dict of covered_px, grown_px, alive blocks
    per level and bits)."""
    h, w = image.shape[:2]
    ch = cfg.channels
    dev = image.device
    grids, levels = [], []
    for lvl in range(num_levels):
        bsz = BLOCK_SIZE << lvl
        px, mask, grid = layout.blockify(image, bsz)
        a, b, fac, accepted, _ = fit_2pt(px, mask, cfg)
        f8 = torch.clamp(torch.round(fac * 255.0), 0, 255).to(torch.int32)
        shift = find_shift_1d(px, mask, f8, a, b, cfg)
        # one axis: the hash's axis-0 bits of each pixel
        q = dither_crush_key(f8[None].expand(3, -1, -1), shift[None].expand(3, -1),
                             level_key(seed, 0, lvl), enabled=cfg.dithering)[0]
        levels.append(dict(a=a, b=b, q=q, shift=shift, accepted=accepted,
                           dec=decode_1d(q, shift, a, b, ch)))
        grids.append(grid)

    # quadtree: a parent is alive when its four children exist and are
    # alive and its own refit was accepted
    alive = [levels[0]["accepted"]]
    for lvl in range(1, num_levels):
        idx, valid = _child_indices(grids[lvl - 1].blocks_y, grids[lvl - 1].blocks_x, dev)
        alive.append(alive[lvl - 1][idx].all(dim=0) & valid.all(dim=0)
                     & levels[lvl]["accepted"])
    owner = _owner_level(alive, grids, num_levels)
    owner_px = layout.broadcast_block_plane(owner, grids[0])
    covered = layout.broadcast_block_plane(alive[0], grids[0])

    def select(planes):
        out = planes[0]
        for lvl in range(1, num_levels):
            out = torch.where(owner_px == lvl, planes[lvl], out)
        return out

    def rows(key):
        return [layout.broadcast_block_plane(lv[key], g, BLOCK_SIZE << lvl)
                for lvl, (lv, g) in enumerate(zip(levels, grids))]

    dec = select([layout.unblockify(lv["dec"], g, BLOCK_SIZE << lvl).permute(2, 0, 1)
                  for lvl, (lv, g) in enumerate(zip(levels, grids))])
    factors = select([layout.unblockify(((lv["q"] << lv["shift"][None]) & 0xFF)[None], g,
                                        BLOCK_SIZE << lvl)[..., 0]
                      for lvl, (lv, g) in enumerate(zip(levels, grids))])
    shift_pl, a_pl, b_pl = select(rows("shift")), select(rows("a")), select(rows("b"))

    src = image[..., :ch].to(torch.int32).permute(2, 0, 1)
    grown = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.pixel_grow:
        covered, dec, a_pl, b_pl, shift_pl, factors, grown = _grow(
            src, covered, dec, a_pl, b_pl, shift_pl, factors, cfg)
    decoded = torch.where(covered[None], dec, src).to(torch.uint8).permute(1, 2, 0)
    if ch == 3:
        decoded = torch.cat([decoded, torch.full((h, w, 1), 0xFF, dtype=torch.uint8,
                                                 device=dev)], dim=-1)
    stats = dict(covered_px=covered.sum(), grown_px=grown, blocks=[a.sum() for a in alive],
                 bits=((8 - shift_pl) * covered).sum())
    return decoded, factors.to(torch.uint8), a_pl, b_pl, shift_pl, covered, stats


def encode_legacy(image, cfg: LegacyConfig | None = None, seed: int = 0, num_levels: int = 3,
                  device="cuda"):
    """Host API mirroring limg_encode_test / limg_encode_info
    (src/limg.h:20-27) and ``limg_tpu.legacy.encode_legacy``: the encode
    runs on ``device``; returns NumPy arrays decoded (H, W, 4), factors,
    col_a / col_b (ch, H, W), shift (H, W) uint8, covered, and coverage
    (percent), total_block_area, grown_px, avg_bits, psnr and mse."""
    cfg = cfg or LegacyConfig()
    img = _as_image_tensor(image, resolve_device(device))
    decoded, factors, a_pl, b_pl, shift_pl, covered, stats = encode_legacy_device(
        img, cfg, seed, num_levels)
    # weighted PSNR (ops/error.py psnr), infinite for a lossless encode
    err = weighted_error(decoded[..., :cfg.channels].to(torch.int32).permute(2, 0, 1),
                         img[..., :cfg.channels].to(torch.int32).permute(2, 0, 1))
    mse = int(err.sum(dtype=torch.int64)) / (img.shape[0] * img.shape[1])
    psnr = 10.0 * np.log10(max_possible_error(cfg.channels) / mse) if mse else float("inf")
    covered_px = int(stats["covered_px"])
    return dict(
        decoded=decoded.cpu().numpy(),
        factors=factors.cpu().numpy(),
        col_a=a_pl.cpu().numpy(),
        col_b=b_pl.cpu().numpy(),
        shift=shift_pl.to(torch.uint8).cpu().numpy(),
        covered=covered.cpu().numpy(),
        coverage=covered_px / (img.shape[0] * img.shape[1]) * 100.0,
        total_block_area=covered_px,
        grown_px=int(stats["grown_px"]),
        avg_bits=float(stats["bits"]) / max(1, covered_px),
        psnr=float(psnr),
        mse=float(mse),
    )
