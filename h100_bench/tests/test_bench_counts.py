"""The frozen work counts (counts/) equal chip_smoke.py's at the 4K shapes.

chip_smoke.py's ``kernel_bound`` reads the port's tensors of a call; the
counts take the frame, the configuration and the content's counts. Here
both see the same 4K (2160 x 3840) call, its tensors built with the
shapes the port gives them.
"""

import pytest
import torch

import chip_smoke
from h100_bench.counts import (common, encode_fixed_p64, encode_region, fit_levels, owner_crush,
                               segment_encode)
from h100_bench.reference import EncodeConfig

H, W = 2160, 3840


def zeros(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


def region_call(p, nb, ch):
    args = (zeros(p, nb), zeros(p, nb, dtype=torch.bool))
    out = (zeros(3, nb), zeros(p, nb), zeros(p, nb), zeros(1, nb, dtype=torch.float32),
           *(zeros(ch, nb) for _ in range(6)), zeros(ch, nb, dtype=torch.float32))
    return args, out


def smoke_ms(name, args, out):
    return chip_smoke.kernel_bound(name, args, out)[0]


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("crush_mode", ["ladder", "exhaustive", "none"])
def test_region_encode_counts(alpha, crush_mode):
    cfg = EncodeConfig(has_alpha=alpha, crush_mode=crush_mode)
    job = common.Job(H, W, cfg, num_levels=4)
    args, out = region_call(64, job.blocks(0), cfg.channels)
    want = smoke_ms("encode_fixed_p64", (*args, cfg), out)
    assert encode_fixed_p64.bound_s("encode_fixed_p64", job) * 1e3 == pytest.approx(want, 1e-12)
    for lvl in (1, 2, 3):
        p = 64 << 2 * lvl
        args, out = region_call(p, job.blocks(lvl), cfg.channels)
        want = smoke_ms("encode_region", (*args, cfg), out)
        got = encode_region.bound_s(f"encode_region_p{p}", job) * 1e3
        assert got == pytest.approx(want, 1e-12), lvl


def test_region_cluster_counts_every_level_from_4():
    cfg = EncodeConfig()
    job = common.Job(H, W, cfg, num_levels=6)
    want = sum(common.region_encode_bound(job, lvl)[0] for lvl in (4, 5))
    assert encode_region.bound_s("encode_region_cluster", job) == want
    assert encode_region.bound_s("encode_region_cluster", common.Job(H, W, cfg, 4)) is None


@pytest.mark.parametrize("alpha", [False, True])
def test_fit_levels_and_owner_crush_counts(alpha):
    cfg = EncodeConfig(has_alpha=alpha)
    ch, levels = cfg.channels, 3
    job = common.Job(H, W, cfg, num_levels=levels)
    nb = job.blocks(0)
    words = zeros(H, W)
    fit_out = (zeros(nb), zeros(nb, 64), zeros(6, ch, nb), zeros(ch, nb, dtype=torch.float32),
               zeros(nb), zeros(nb), zeros(levels - 1, nb))
    want = smoke_ms("fit_levels", (words, cfg, levels), fit_out)
    assert fit_levels.bound_s("fit_levels", job) * 1e3 == pytest.approx(want, 1e-12)
    for emit_q in (False, True):
        args = (words, zeros(nb), zeros(64, nb), zeros(6, ch, nb), cfg, levels, 0, emit_q)
        out = (zeros(3, nb), zeros(64, nb) if emit_q else None, zeros(64, nb),
               zeros(nb, dtype=torch.float32), zeros(nb, dtype=torch.float32), zeros(nb))
        want = smoke_ms("owner_crush", args, out)
        got = owner_crush.bound_s("owner_crush", job, emit_q=emit_q) * 1e3
        assert got == pytest.approx(want, 1e-12), emit_q


@pytest.mark.parametrize("emit_q", [False, True])
def test_segment_encode_member_rule(emit_q):
    cfg = EncodeConfig()
    ch, lanes, members = cfg.channels, 131072, 94047      # the 4K default's run blocks
    mask = zeros(64, lanes, dtype=torch.bool)
    mask[:, :members] = True
    args = (zeros(64, lanes), mask, zeros(lanes), zeros(lanes), cfg, 0, emit_q)
    out = (zeros(3, lanes), zeros(64, lanes) if emit_q else None, zeros(64, lanes),
           zeros(lanes, dtype=torch.float32), zeros(lanes), zeros(lanes), zeros(6, ch, lanes),
           zeros(ch, lanes, dtype=torch.float32))
    want = smoke_ms("segment_encode", args, out)
    job = common.Job(H, W, cfg, 3, {"segment_encode": {"members": members, "lanes": lanes}})
    got = segment_encode.bound_s("segment_encode_p64", job, emit_q=emit_q) * 1e3
    assert got == pytest.approx(want, 1e-12)
    assert segment_encode.bound_s("segment_encode_p64", common.Job(H, W, cfg, 5)) is None
    assert segment_encode.bound_s("segment_encode_p256", job) is None
