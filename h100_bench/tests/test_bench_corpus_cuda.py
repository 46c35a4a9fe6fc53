"""The four-card corpus cell on four cards: a run at test size, and the
faults planted in the exchange between cards read on one full-size batch.

    python -m pytest h100_bench/tests/test_bench_corpus_cuda.py -m cuda -q

Skips where torch sees fewer than four cards.
"""

import json

import pytest
import torch

import limg_tpu_torch
from h100_bench import control, reference
from h100_bench.harness import entry as entries
from h100_bench.harness import main as harness
from h100_bench.harness import spec
from h100_bench.tests.test_bench_corpus import CELL, FAULTS, H, W, run_small

pytestmark = pytest.mark.cuda


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (run on a machine of four cards with -m cuda)")
    return harness.cell_devices(4)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_corpus_cell_on_four_cards(monkeypatch, four_cards, trace):
    """Correct with every gap 0.0; every card holds memory and, traced, is
    busy; the upload readers and the fixed grid's roofline read."""
    result, lines, run = run_small(monkeypatch, limg_tpu_torch, trace, four_cards,
                                   seconds=1.0)
    print(result)
    assert result["correct"] is True and result["failed"] == 0, lines
    assert all(c["value"] == 0.0 for c in result["check"].values())
    assert run.pixels == run.images * 32 * H * W
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 4
    peaks = dev["memory_peak_bytes_per_card"]
    assert len(peaks) == 4 and min(peaks) > 0
    if trace:
        m = result["metrics"]
        assert len(dev["busy_s_per_card"]) == 4 and min(dev["busy_s_per_card"]) > 0
        assert m["h2d_ms_per_image"]["value"] > 0
        assert 0 < m["h2d_link_roofline"]["value"] <= 100
        assert 0 < m["encode_fixed_p64_roofline"]["value"] <= 100


def test_faults_between_cards_at_full_size(monkeypatch, four_cards):
    """One call of the cell's own 32-frame 3840x2160 batch: the sound port
    reads 0.0 on every number, and each planted fault puts the frames of its
    shards wrong, which ``frames_off`` counts whatever the gaps read; so does
    the control. Prints every reading."""
    cell = spec.load_cell(CELL)
    entry = entries.load(cell.config)
    params = dict(cell.config.get("call", {}))
    seed = 2**31 + 4099
    batch = spec.load_module("traffic", cell.traffic["generator"]).make_pool(
        dict(cell.traffic, pool=1), seed, four_cards)[0]
    want = entry.call(reference, batch, entries.encode_config(reference, cell.config), seed,
                      params, four_cards)
    cfg = entries.encode_config(limg_tpu_torch, cell.config)

    def reading(lib=limg_tpu_torch, cfg=cfg):
        got = entry.call(lib, batch, cfg, seed, params, four_cards)
        return entry.compare(got, want, batch)

    readings = {"sound": reading(),
                "control": reading(control, entries.encode_config(control, cell.config))}
    for name, (plant, _) in sorted(FAULTS.items()):
        with monkeypatch.context() as m:
            plant(m)
            readings[name] = reading()
    print(json.dumps(dict(readings, psnr_of_the_frames=[float(v) for v in want.totals["psnr"]],
                          bpp_of_the_frames=[float(v) for v in want.totals["bpp"]])))
    limits = cell.settings["limits"]
    assert readings.pop("sound") == dict.fromkeys(limits, 0.0)
    assert readings.pop("control")["frames_off"] > limits["frames_off"]
    for name, numbers in readings.items():
        assert numbers["frames_off"] == FAULTS[name][1] > limits["frames_off"], name
