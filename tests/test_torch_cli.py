"""limg_tpu_torch.cli on the CPU: the ported modes run, the others exit
naming their ROADMAP.md item; the fixed-grid stats match limg_tpu.cli's."""

import re

import numpy as np
import pytest
import torch

from limg_tpu import cli as jcli
from limg_tpu_torch import cli as tcli
from limg_tpu_torch.utils.timing import time_device_fn, time_device_fns
from tests.conftest import make_test_image

torch.set_num_threads(1)


@pytest.fixture()
def image_files(tmp_path):
    from PIL import Image

    img = make_test_image(np.random.default_rng(77), 40, 56)
    np.save(tmp_path / "img.npy", img[..., :3])
    Image.fromarray(img[..., :3], "RGB").save(tmp_path / "img.png")
    return tmp_path


def _stats(text):
    """(bits lines, PSNR in dB) from a fixed-grid stats print."""
    bits = [re.sub(r"\s+", " ", ln) for ln in text.splitlines()
            if ln.startswith(("Average Block Bits", "Compression Average"))]
    psnr = float(re.search(r"PSNR: ([0-9.]+) dB", text).group(1))
    return bits, psnr


def test_fixed_grid_matches_jax_cli(image_files, capsys, monkeypatch):
    monkeypatch.chdir(image_files)
    png = str(image_files / "img.png")
    tcli.main([png, "--fixed-grid", "--no-output", "--device", "cpu"])
    t_out = capsys.readouterr().out
    jcli.main([png, "--fixed-grid", "--no-output", "--no-pallas"])
    j_out = capsys.readouterr().out
    assert "limg_tpu_torch encode completed on cpu" in t_out
    (t_bits, t_psnr), (j_bits, j_psnr) = _stats(t_out), _stats(j_out)
    assert len(t_bits) == 2 and t_bits == j_bits
    # the CLI dithers; the two packages draw different noise
    assert abs(t_psnr - j_psnr) <= 0.3


def test_fixed_grid_writes_planes_from_npy(image_files, capsys, monkeypatch):
    monkeypatch.chdir(image_files)
    tcli.main([str(image_files / "img.npy"), "--fixed-grid", "--device", "cpu",
               "--accurate-bit-crushing", "--factors", "2"])
    assert "Wrote decoded file." in capsys.readouterr().out
    names = ["out", "fac_a", "fac_b", "fac_c", "bpp", "bits", "col_a_min", "col_a_max",
             "col_b_min", "col_b_max", "col_c_min", "col_c_max"]
    for n in names:
        assert (image_files / f"limg_{n}.tga").stat().st_size > 18, n


def test_list_mode_runs(image_files, capsys):
    npy = str(image_files / "img.npy")
    tcli.main(["--", "--count", "2", "--device", "cpu", "--", npy])
    assert "Throughput" in capsys.readouterr().out
    tcli.main(["--", "--device", "cpu", "--", npy, npy])
    assert "Processed" in capsys.readouterr().out


def test_merged_mode_prints_stats_and_writes_planes(image_files, capsys, monkeypatch):
    """Without --fixed-grid the CLI runs the default merged encode: the
    stats print and the 13 TGA planes of limg_tpu.cli's merged branch."""
    from limg_tpu_torch import EncodeConfig, encode_image_merged

    monkeypatch.chdir(image_files)
    npy = str(image_files / "img.npy")
    tcli.main([npy, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "limg_tpu_torch encode completed on cpu" in text and "Wrote decoded file." in text
    names = ["out", "fac_a", "fac_b", "fac_c", "bpp", "bits", "col_a_min", "col_a_max",
             "col_b_min", "col_b_max", "col_c_min", "col_c_max", "block_idx"]
    for n in names:
        assert (image_files / f"limg_{n}.tga").stat().st_size > 18, n
    assert len(list(image_files.glob("*.tga"))) == 13
    out = encode_image_merged(np.load(npy), EncodeConfig(), device="cpu")
    bits, psnr = _stats(text)
    assert f"{out['mean_bpp']:7.4f}" in bits[1] and abs(psnr - out["psnr"]) < 0.005
    assert jcli._hash_color(12345) == tcli._hash_color(12345)
    tcli.main([npy, "--device", "cpu", "--fast-coalesce", "--no-output"])
    assert "Compression Average" in capsys.readouterr().out


@pytest.mark.parametrize("args,item", [
    (["--fixed-grid", "--rd-merge"], "Queue 1 item 12"),
    (["--write-ltp1", "out.ltp1"], "Queue 1 item 10"),
    (["--diagnose"], "Queue 1 item 11"),
])
def test_unported_modes_exit_naming_roadmap_item(image_files, capsys, args, item):
    with pytest.raises(SystemExit) as e:
        tcli.main([str(image_files / "img.npy"), *args, "--device", "cpu"])
    assert e.value.code != 0
    assert f"ROADMAP.md {item}" in capsys.readouterr().out


def test_decode_ltp1_and_bad_flags_exit(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--decode-ltp1", "x.ltp1"])
    assert e.value.code != 0 and "ROADMAP.md Queue 1 item 10" in capsys.readouterr().out
    for bad in (["img.npy", "--use-pallas"], ["img.npy", "--device", "tpu"], ["img.npy", "--bogus"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(bad)
        assert e.value.code == 1


def test_timing_on_cpu_uses_host_clock():
    calls = []
    per, det = time_device_fn(lambda: calls.append(1), device="cpu", iters=6, inner=3)
    assert det["clock"] == "host" and len(det["samples_s"]) == 2
    assert len(calls) == 1 + 6 and per >= 0.0
    samples = time_device_fns({"a": lambda: None, "b": lambda: None}, "cpu", rounds=3, inner=2)
    assert set(samples) == {"a", "b"} and all(len(v) == 3 for v in samples.values())
