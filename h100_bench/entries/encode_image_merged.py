"""``encode_image_merged``: the quadtree-merged encode, as its users call it.

The window calls ``lib.encode_image_merged(image, cfg, seed, **call)`` with
the configuration's ``call`` settings (``fetch_planes=False``,
``fetch_decoded=False``): the result is the totals the entry returns on the
host (alive counts, merge stats, runs, coalesce stats, bits histogram,
bpp, error). Those are what the check compares with the reference's, one
number per layer the encode runs.
"""

from __future__ import annotations

import numpy as np

from ..harness.entry import Output


def call(lib, image, cfg, seed: int, params: dict, device) -> Output:
    return Output(lib.encode_image_merged(image, cfg, seed, device=device, **params), None)


def _gap(got, want) -> float:
    """|got - want| over |want| (at least 1), the worst element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def _stats_gap(got: list, want: list) -> float:
    if len(got) != len(want) or any(set(g) != set(w) for g, w in zip(got, want)):
        return float("inf")
    return max([0.0] + [_gap(g[k], w[k]) for g, w in zip(got, want) for k in w])


def compare(got: Output, want: Output, image) -> dict:
    """The gaps of the program's totals from the reference's:

    - ``alive_gap``: alive regions per level (level fits, merge test, owner
      choice), relative, the worst level;
    - ``merge_gap``: the merge test's reason counts per level, relative;
    - ``runs_gap``: runs and coalesce stats (run building, coalescing),
      relative;
    - ``hist_gap``: the bits histogram's L1 gap over its total (owner crush,
      segment re-encode);
    - ``err_gap``: the total weighted error's, relative (crush, dither,
      decode);
    - ``bpp_gap``: the mean bits per pixel's, relative.
    """
    g, w = got.totals, want.totals
    hist_g, hist_w = np.asarray(g["bits_histogram"], np.int64), np.asarray(w["bits_histogram"],
                                                                          np.int64)
    hist = (float(np.abs(hist_g - hist_w).sum()) / max(int(hist_w.sum()), 1)
            if hist_g.shape == hist_w.shape else float("inf"))
    runs = max(_gap(g["n_runs"], w["n_runs"]),
               _stats_gap([g["coalesce_stats"]], [w["coalesce_stats"]]))
    return dict(
        alive_gap=_gap(g["alive_counts"], w["alive_counts"]),
        merge_gap=_stats_gap(g["merge_stats"], w["merge_stats"]),
        runs_gap=runs,
        hist_gap=hist,
        err_gap=abs(g["mse"] - w["mse"]) / max(abs(w["mse"]), 1e-12),
        bpp_gap=abs(g["mean_bpp"] - w["mean_bpp"]) / max(abs(w["mean_bpp"]), 1e-12),
    )


def run_members(lib, image, cfg, seed: int, params: dict, device) -> dict:
    """Work counts of the fused path's coalesce pass for the kernel counts:
    the run blocks (the segment encode's member lanes) and the run buffer's
    lanes, from ``lib``'s pre stage (the reference's; run building does not
    depend on the seed). Empty for the dense path."""
    levels = params.get("num_levels", 3)
    if not 2 <= levels <= 4:
        return {}
    state = lib.fused_merged_pre(image, cfg, seed, levels, need_q=False, device=device)
    n_run = int(state["n_run_blocks"])
    nb = state["grid"].num_blocks
    return {"segment_encode": {"members": n_run, "lanes": lib.auto_run_capacity(n_run, nb)}}
