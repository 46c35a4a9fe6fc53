"""Quadtree-merged encoder, fused path, match policy, without run coalescing.

The counterpart of the JAX package's fused merged encode
(limg_tpu/regions.py: ``_fused_pre_body`` :1182, ``_fused_finish_body``
:1393, ``encode_image_merged_fused_device`` :1544, ``encode_image_merged``
:1828) with ``coalesce=False``: every quadtree level is fitted, each
parent merges when all four children are alive and match its first child,
every block is crushed once at its owner level, and the stats and planes
come from per-block rows. On a CUDA device this is one launch each of the
two hand-written kernels (kernels/encode_merged.py); on the CPU it is
their plain versions.

Not ported here, and raising NotImplementedError: run coalescing
(``coalesce=True``, the JAX default), the RD policy, the LTP1 serializer
state and the dense path (``num_levels`` outside 2-4).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import BLOCK_SIZE, EncodeConfig, static_block_bits
from .encoder import _as_image_tensor, resolve_device
from .kernels.encode_merged import MAX_LEVELS, MIN_LEVELS, fit_levels_kernel, owner_crush_kernel
from .ops import layout
from .ops.error import max_possible_error
from .ops.match import MATCH_REASON_BITS

# argument -> the ROADMAP.md item that ports it
_NOT_PORTED = {
    "coalesce": "Queue 1 item 9, run coalescing",
    "merge_policy": "Queue 1 item 12",
    "return_state": "Queue 1 item 10",
    "num_levels": "Queue 1 item 13",
}


def _check_supported(num_levels: int, coalesce: bool, merge_policy: str,
                     return_state: bool) -> None:
    def refuse(arg, what):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md {_NOT_PORTED[arg]})")

    if coalesce:
        refuse("coalesce", "coalesce=True (run coalescing)")
    if merge_policy != "match":
        refuse("merge_policy", f"merge_policy={merge_policy!r}")
    if return_state:
        refuse("return_state", "return_state=True (LTP1 serializer state)")
    if not MIN_LEVELS <= num_levels <= MAX_LEVELS:
        refuse("num_levels", f"num_levels={num_levels} (the dense merged path)")


def _words(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3|4) uint8 -> (H, W) int32 words, R lowest; RGB gets alpha 0."""
    if image.shape[2] == 3:
        image = torch.nn.functional.pad(image, (0, 1))
    return layout.packed_words(image).contiguous()


def _leaders(owner0: torch.Tensor, grid: layout.BlockGrid, num_levels: int):
    """Row-major index of each block's region leader (the top-left block of
    its owner-level square)."""
    dev = owner0.device
    yy = torch.arange(grid.blocks_y, device=dev)[:, None]
    xx = torch.arange(grid.blocks_x, device=dev)[None, :]
    lead0 = (yy * grid.blocks_x + xx).reshape(-1)
    for lvl in range(1, num_levels):
        lp = (((yy >> lvl) << lvl) * grid.blocks_x + ((xx >> lvl) << lvl)).reshape(-1)
        lead0 = torch.where(owner0 == lvl, lp, lead0)
    return lead0.to(torch.int32)


def _fused_pre(img: torch.Tensor, cfg: EncodeConfig, seed: int, num_levels: int,
               need_q: bool):
    """Stages A-D: fit every level, merge test and owner select (one kernel),
    crush at the owner level (one kernel), per-block leaders and bits."""
    ch = cfg.channels
    words = _words(img)
    grid = layout.grid_for(*words.shape)
    fit = fit_levels_kernel(words, cfg, num_levels)
    crush = owner_crush_kernel(words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, num_levels,
                               seed, emit_q=need_q)
    merge_stats = [{name: (r & bit).ne(0).sum() for name, bit in MATCH_REASON_BITS}
                   for r in fit.reasons]
    lead0 = _leaders(fit.owner, grid, num_levels)
    s_eff0 = torch.clamp(crush.shifts, max=8)
    fac_bits0 = ((8 - s_eff0) * fit.cnt0[None]).sum(dim=0, dtype=torch.int32)
    is_leader0 = lead0 == torch.arange(grid.num_blocks, device=lead0.device)
    return dict(
        grid=grid, fit=fit, crush=crush, merge_stats=merge_stats, lead0=lead0,
        # per-block bits with the region header on its leader: what the run
        # coalescing pass (not ported yet) weighs a refit against
        bits0=fac_bits0 + static_block_bits(ch) * is_leader0.to(torch.int32),
    )


def _decoded_image(dec_packed: torch.Tensor, grid: layout.BlockGrid) -> torch.Tensor:
    """(64, NB) packed decoded words -> (H, W, 4) uint8."""
    words = layout.unblockify(dec_packed[None], grid, BLOCK_SIZE)[..., 0]
    return words.contiguous().view(torch.uint8).reshape(grid.height, grid.width, 4)


def _fused_finish(state: dict, num_levels: int, emit_planes: bool):
    """Stage G without coalescing: stats as flat level-0 sums, the decoded
    image, and with ``emit_planes`` the per-block planes."""
    grid, fit, crush = state["grid"], state["fit"], state["crush"]
    cnt0 = fit.cnt0.to(torch.int64)
    s_eff0 = torch.clamp(crush.shifts, max=8).to(torch.int64)
    one_hot = s_eff0[:, None, :] == torch.arange(9, device=s_eff0.device)[None, :, None]
    out = dict(
        decoded=_decoded_image(crush.dec, grid),
        accum_bits=((8 - s_eff0) * cnt0[None]).sum(dim=1),
        bits_histogram=(one_hot * cnt0[None, None, :]).sum(dim=2),
        alive_counts=torch.stack([((fit.stats_bits >> lvl) & 1).sum()
                                  for lvl in range(num_levels)]),
        mean_bpp=(crush.bpp.to(torch.float64) * cnt0).sum() / (grid.height * grid.width),
        total_err=crush.dist_blk.to(torch.float64).sum(),
        merge_stats=state["merge_stats"],
        n_runs=torch.zeros((), dtype=torch.int32, device=cnt0.device),
        coalesce_stats={},
    )
    if emit_planes:
        nb = grid.num_blocks
        out["endpoint_rows"] = fit.eps_sel.reshape(-1, nb)
        out["block_rows8"] = torch.cat(
            [s_eff0, crush.bpp[None].to(torch.int64),
             fit.owner[None].to(torch.int64)]).to(torch.uint8)               # (5, NB)
        out["region_rows"] = fit.owner * nb + state["lead0"]
        q = torch.stack([(crush.q >> (8 * k)) & 0xFF for k in range(3)])
        out["factors_pnb"] = ((q << s_eff0[:, None, :]) & 0xFF).to(torch.uint8)
    return out


def encode_image_merged_fused_device(image, cfg: EncodeConfig, seed: int = 0,
                                     num_levels: int = 3, emit_planes: bool = True,
                                     coalesce: bool = True, return_state: bool = False,
                                     merge_policy: str = "match", device="cuda"):
    """Fused merged encode with every output left on ``device``.

    Returns a dict: ``decoded`` (H, W, 4) uint8, ``accum_bits`` (3,),
    ``bits_histogram`` (3, 9), ``alive_counts`` (num_levels,), ``mean_bpp``
    and ``total_err`` (float64 scalars), ``merge_stats`` (one dict of
    reason counts per level 1..num_levels-1), ``n_runs`` (0) and
    ``coalesce_stats`` ({}); with ``emit_planes`` also ``endpoint_rows``
    (6ch, NB), ``block_rows8`` (5, NB) uint8 [3 shifts, bpp, owner],
    ``region_rows`` (NB,) and ``factors_pnb`` (3, 64, NB) uint8.
    """
    _check_supported(num_levels, coalesce, merge_policy, return_state)
    dev = resolve_device(device)
    img = _as_image_tensor(image, dev)
    state = _fused_pre(img, cfg, seed, num_levels, need_q=emit_planes)
    return _fused_finish(state, num_levels, emit_planes)


def encode_image_merged(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
                        fetch_planes: bool = True, merge_policy: str = "match",
                        coalesce: bool = True, return_state: bool = False,
                        fetch_decoded: bool = True, device="cuda"):
    """Host-facing merged encode, with the output dict of
    ``limg_tpu.regions.encode_image_merged``: decoded, alive_counts,
    bits_histogram, psnr, mse, mean_bpp, avg_block_bits, merge_stats,
    n_runs, coalesce_stats, and with ``fetch_planes`` factors, shift, bpp,
    region_id, owner_px and endpoint_rows (NumPy arrays)."""
    out = encode_image_merged_fused_device(image, cfg, seed, num_levels, fetch_planes,
                                           coalesce, return_state, merge_policy, device)
    h, w = out["decoded"].shape[:2]
    n = h * w
    mse = float(out["total_err"]) / n
    np_out = dict(
        decoded=out["decoded"].cpu().numpy() if fetch_decoded else None,
        alive_counts=out["alive_counts"].cpu().numpy(),
        bits_histogram=out["bits_histogram"].cpu().numpy(),
        psnr=10.0 * math.log10(max_possible_error(cfg.channels) / max(mse, 1e-12)),
        mse=mse,
        mean_bpp=float(out["mean_bpp"]),
        avg_block_bits=float(out["accum_bits"].sum()) / n,
        merge_stats=[{k: float(v) for k, v in s.items()} for s in out["merge_stats"]],
        n_runs=int(out["n_runs"]),
        coalesce_stats={},
    )
    if fetch_planes:
        by, bx = -(-h // BLOCK_SIZE), -(-w // BLOCK_SIZE)

        def expand(rows):
            v = np.asarray(rows).reshape(-1, by, bx)
            v = np.repeat(np.repeat(v, BLOCK_SIZE, 1), BLOCK_SIZE, 2)
            return v[:, :h, :w]

        grid = layout.grid_for(h, w)
        rows8 = out["block_rows8"].cpu().numpy()
        np_out.update(
            factors=layout.unblockify(out["factors_pnb"], grid).cpu().numpy(),
            shift=expand(rows8[:3]),
            bpp=expand(rows8[3])[0],
            region_id=expand(out["region_rows"].cpu().numpy())[0],
            owner_px=expand(rows8[4])[0],
            endpoint_rows=out["endpoint_rows"].cpu().numpy(),
        )
    return np_out
