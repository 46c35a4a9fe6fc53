"""The launch seam of the kernel wrappers (limg_tpu_torch/kernels/launch.py),
on the CPU: the device rule, the crush settings the kernels take, and
every wrapper's public kernel entry running its plain version on CPU
tensors without counting a launch."""

import ctypes
import re

import numpy as np
import pytest
import torch

from limg_tpu_torch import EncodeConfig
from limg_tpu_torch.kernels import (build, coalesce, crush_eval, encode_fixed, encode_merged,
                                    encode_natural, fixed_planes, launch, seg_fold)
from limg_tpu_torch.ops import layout


def test_on_card_routes_by_device():
    assert launch.on_card(torch.device("cpu")) is False
    assert launch.on_card("cpu") is False
    assert launch.on_card(torch.device("cuda", 1)) is True
    with pytest.raises(RuntimeError, match="^no kernel for device meta$"):
        launch.on_card(torch.device("meta"))


@pytest.mark.parametrize("mode,code", [("none", 0), ("ladder", 1), ("exhaustive", 2),
                                       ("guess", 3), ("unknown", 1)])
@pytest.mark.parametrize("dithering", [False, True])
def test_crush_args_are_the_kernels_settings(mode, code, dithering):
    cfg = EncodeConfig(error_factor=100, crush_mode=mode, dithering=dithering, ladder_k=5,
                       num_factors=2)
    want = (code, int(dithering and mode != "none"), 5, 2, cfg.max_pixel_bit_crush_error,
            cfg.max_block_bit_crush_error, 0xC0FFEE)
    assert launch.crush_args(cfg, 0xC0FFEE) == want


def _c_type(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return ctypes.c_uint32 if "uint32_t" in param else ctypes.c_int


@pytest.mark.parametrize("name", sorted(launch.SIGNATURES))
def test_signatures_match_the_c_entries(name):
    """Each table entry declares its C entry's parameters, the stream last."""
    src = (build.CSRC / f"{name}.cu").read_text()
    for fn_name, argtypes in launch.SIGNATURES[name].items():
        params = re.search(rf"\bint\s+{fn_name}\s*\(([^)]*)\)\s*{{", src).group(1).split(",")
        assert params[-1].split() == ["void*", "stream"]
        assert argtypes == [_c_type(p) for p in params]


def test_crush_args_without_crush_bits():
    cfg = EncodeConfig(error_factor=0, crush_mode="exhaustive", dithering=True)
    assert not cfg.crush_bits
    assert launch.crush_args(cfg, 7)[:2] == (0, 0)


def _words(h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -2**31, 2**31, (h, w)).astype(np.int32))


def _blocks(p, n, seed):
    g = torch.Generator().manual_seed(seed)
    packed = torch.randint(0, 2**24, (p, n), dtype=torch.int32, generator=g)
    mask = torch.rand((p, n), generator=g) < 0.9
    return packed, mask


def _rows(ch, *shape):
    g = torch.Generator().manual_seed(ch)
    return torch.randint(-30, 200, (7 * ch, *shape), generator=g).to(torch.float32)


def _fit(cfg, levels, natural=False):
    words = _words(20, 36, 5)
    mod = encode_natural if natural else encode_merged
    plain = mod.fit_levels_natural_reference if natural else mod.fit_levels_reference
    fit = plain(words, cfg, levels)
    return (words, fit.owner, fit.f8_sel, fit.eps_sel, cfg, levels, 3)


def _segment_buffer():
    packed, mask = _blocks(64, 10, 4)
    seg = torch.tensor([0, 0, 0, 3, 4, 4, 6, 6, 6, 6], dtype=torch.int32)
    return packed, mask, seg, torch.arange(10, dtype=torch.int32)


def _fixed_planes_args():
    grid = layout.grid_for(20, 36)
    q, dec = _blocks(grid.num_blocks, 64, 6)[0], _blocks(grid.num_blocks, 64, 7)[0]
    return q, dec, 3, grid


def _crush_eval_args():
    from tools.record_torch_natural_reference import crush_eval_inputs

    return (*(torch.from_numpy(np.ascontiguousarray(a)) for a in crush_eval_inputs(3, n=9, k=4)),
            3)


CFG = EncodeConfig(error_factor=100)
SCAN = [coalesce.ScanProblem(torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32), [None], "s")]

# wrapper entry -> (plain version, arguments)
ENTRIES = {
    "encode_blocks_kernel P=64": (encode_fixed.encode_blocks_kernel,
                                  encode_fixed.encode_blocks_reference,
                                  lambda: (*_blocks(64, 12, 1), CFG, 3, True)),
    "encode_blocks_kernel P=256": (encode_fixed.encode_blocks_kernel,
                                   encode_fixed.encode_blocks_reference,
                                   lambda: (*_blocks(256, 5, 2), CFG, 3)),
    "fixed_planes_kernel": (fixed_planes.fixed_planes_kernel,
                            fixed_planes.fixed_planes_reference, _fixed_planes_args),
    "crush_eval_rows_kernel": (crush_eval.crush_eval_rows_kernel,
                               crush_eval.crush_eval_rows_reference, _crush_eval_args),
    "seg_sum_fold_kernel": (seg_fold.seg_sum_fold_kernel, seg_fold.seg_sum_fold_reference,
                            lambda: (torch.rand(2, 8), torch.tensor([1, 0, 1, 3, 3, 0, 1, 2]), 4)),
    "fit_levels_kernel": (encode_merged.fit_levels_kernel, encode_merged.fit_levels_reference,
                          lambda: (_words(20, 36, 5), CFG, 2)),
    "owner_crush_kernel": (encode_merged.owner_crush_kernel,
                           encode_merged.owner_crush_reference, lambda: _fit(CFG, 2)),
    "fit_levels_natural_kernel": (encode_natural.fit_levels_natural_kernel,
                                  encode_natural.fit_levels_natural_reference,
                                  lambda: (_words(20, 36, 5), CFG, 3)),
    "owner_crush_natural_kernel": (encode_natural.owner_crush_natural_kernel,
                                   encode_natural.owner_crush_natural_reference,
                                   lambda: _fit(CFG, 3, natural=True)),
    "match_pairs_kernel": (coalesce.match_pairs_kernel, coalesce.match_pairs_reference,
                           lambda: (_rows(3, 40), _rows(3, 40).flip(1), 3)),
    "match_neighbors_kernel": (coalesce.match_neighbors_kernel,
                               coalesce.match_neighbors_reference, lambda: (_rows(4, 5, 7), 4)),
    "seg_scan": (coalesce.seg_scan, coalesce.seg_scan_reference, lambda: (SCAN,)),
    "seg_mixed_all_kernel": (coalesce.seg_mixed_all_kernel, coalesce.seg_mixed_all_reference,
                             lambda: (torch.arange(10, dtype=torch.int32).reshape(2, 5),
                                      SCAN[0].seg, 1)),
    "segment_encode_kernel": (coalesce.segment_encode_kernel,
                              coalesce.segment_encode_reference,
                              lambda: (*_segment_buffer(), CFG, 0x5EED)),
}


def _flat(outs):
    if isinstance(outs, torch.Tensor) or outs is None:
        return [outs]
    return [t for o in outs for t in _flat(o)]


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_wrapper_runs_its_plain_version_on_the_cpu(entry):
    kernel, plain, make_args = ENTRIES[entry]
    args = make_args()
    before = launch.launches.copy()
    got = kernel(*args)
    assert launch.launches == before
    got, want = _flat(got), _flat(plain(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def test_launches_reset():
    launch.launches["fixed_planes"] += 2
    launch.reset_launches()
    assert launch.launches == {} and launch.launches["fixed_planes"] == 0
