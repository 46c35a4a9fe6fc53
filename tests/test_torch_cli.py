"""limg_tpu_torch.cli on the CPU: the ported modes run, ``--fixed-grid
--write-ltp1`` exits naming its ROADMAP.md item; the fixed-grid stats match
limg_tpu.cli's, the LTP1 stream JAX's bytes and the culprit block JAX's."""

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


def test_rd_merge_mode_runs(image_files, capsys, monkeypatch):
    """``--rd-merge`` (ROADMAP.md Queue 1 item 12, once refused) runs the
    merged encode under the RD policy and prints its stats; with
    ``--fixed-grid`` the fixed grid wins, as in limg_tpu.cli."""
    from limg_tpu_torch import EncodeConfig, encode_image, encode_image_merged

    monkeypatch.chdir(image_files)
    npy = str(image_files / "img.npy")
    tcli.main([npy, "--rd-merge", "--device", "cpu", "--no-output"])
    bits, psnr = _stats(capsys.readouterr().out)
    img = np.load(npy)
    out = encode_image_merged(img, EncodeConfig(), merge_policy="rd", device="cpu")
    assert f"{out['mean_bpp']:7.4f}" in bits[1] and abs(psnr - out["psnr"]) < 0.005
    tcli.main([npy, "--fixed-grid", "--rd-merge", "--device", "cpu", "--no-output"])
    bits, psnr = _stats(capsys.readouterr().out)
    assert abs(psnr - encode_image(img, EncodeConfig(), device="cpu")["psnr"]) < 0.005
    assert not list(image_files.glob("*.tga"))


def _merged_encode(npy):
    """The CLI's default merged encode of ``npy`` and its state, on the CPU."""
    from limg_tpu_torch import EncodeConfig, encode_image_merged

    image, has_alpha = tcli.load_any(npy)
    return image, encode_image_merged(image, EncodeConfig(has_alpha=has_alpha),
                                      return_state=True, device="cpu")


def test_write_ltp1_writes_jax_bytes_from_the_port_state(image_files, capsys, monkeypatch):
    from limg_tpu import bitstream
    from limg_tpu.config import EncodeConfig as JConfig

    monkeypatch.chdir(image_files)
    npy = str(image_files / "img.npy")
    tcli.main([npy, "--write-ltp1", "out.ltp1", "--no-output", "--device", "cpu"])
    text = capsys.readouterr().out
    blob = (image_files / "out.ltp1").read_bytes()
    _, (out, state) = _merged_encode(npy)
    assert blob == bitstream.serialize_from_state(state, JConfig())
    assert f"Wrote out.ltp1: {len(blob)} bytes = " in text and "real bits per pixel" in text
    assert f"{out['mean_bpp']:7.4f}" in _stats(text)[0][1]
    assert not list(image_files.glob("*.tga"))


@pytest.mark.parametrize("flag_first", [True, False])
def test_decode_ltp1_writes_the_decoded_tga(image_files, capsys, monkeypatch, flag_first):
    from limg_tpu_torch import native

    monkeypatch.chdir(image_files)
    npy = str(image_files / "img.npy")
    tcli.main([npy, "--write-ltp1", "s.ltp1", "--no-output", "--device", "cpu"])
    capsys.readouterr()
    tcli.main(["--decode-ltp1", "s.ltp1"] if flag_first else ["s.ltp1", "--decode-ltp1"])
    text = capsys.readouterr().out
    assert "56 x 40 pixels, 3 levels, errorFactor 100, real " in text
    assert "Wrote limg_decoded.tga." in text
    _, (out, _) = _merged_encode(npy)
    np.testing.assert_array_equal(native.read_tga(str(image_files / "limg_decoded.tga")),
                                  out["decoded"])


@pytest.mark.parametrize("fixed_grid", [False, True])
def test_diagnose_prints_jax_culprit_block(image_files, capsys, monkeypatch, fixed_grid):
    """The culprit block is JAX's ``format_culprits`` of the port's counts:
    the merged encode's regions from its state, or a fixed-grid refit's
    blocks."""
    from limg_tpu.utils.diagnostics import format_culprits
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.ops import layout
    from limg_tpu_torch.ops.crush import find_shifts
    from limg_tpu_torch.ops.factors import extract_factors, quantize_factors
    from limg_tpu_torch.ops.fit import fit_blocks
    from limg_tpu_torch.utils import diagnostics

    monkeypatch.chdir(image_files)
    npy = str(image_files / "img.npy")
    tcli.main([npy, "--diagnose", "--no-output", "--device", "cpu",
               *(["--fixed-grid"] if fixed_grid else [])])
    text = capsys.readouterr().out
    image, (out, state) = _merged_encode(npy)
    cfg = EncodeConfig()
    if fixed_grid:
        px, mask, _ = layout.blockify(torch.from_numpy(image))
        d = fit_blocks(px, mask, cfg.channels)
        f8 = quantize_factors(*extract_factors(px, d, cfg.channels))
        shifts, _ = find_shifts(px, mask, f8, d, cfg)
        block = format_culprits(diagnostics.crush_culprits(px, mask, f8, d, shifts, cfg))
        assert block.count("\n") == 5
    else:
        culprits = diagnostics.crush_culprits_merged(image, state, cfg, device="cpu")
        block = format_culprits(culprits, out["merge_stats"], out["coalesce_stats"])
        assert "-- Block Merge" in block and "-- Coalescing" in block
    assert block in text
    assert text.index("PSNR") < text.index("CULPRIT info:")


def test_fixed_grid_write_ltp1_exits_naming_item_13(image_files, capsys, monkeypatch):
    """``--fixed-grid --write-ltp1`` (refused naming ROADMAP.md Queue 1 item
    13 until the dense path landed) writes the stream of a 1-level merged
    encode, as limg_tpu.cli does, and ``--decode-ltp1`` decodes it to that
    encode's image bit for bit."""
    from limg_tpu_torch import EncodeConfig, bitstream, encode_image_merged, native

    monkeypatch.chdir(image_files)
    npy = str(image_files / "img.npy")
    tcli.main([npy, "--fixed-grid", "--write-ltp1", "f.ltp1", "--no-output", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Wrote f.ltp1" in text and "ROADMAP" not in text
    image, has_alpha = tcli.load_any(npy)
    cfg = EncodeConfig(has_alpha=has_alpha)
    blob = (image_files / "f.ltp1").read_bytes()
    assert blob == bitstream.serialize(image, cfg, num_levels=1, device="cpu")
    tcli.main(["--decode-ltp1", "f.ltp1"])
    assert "1 levels" in capsys.readouterr().out
    want = encode_image_merged(image, cfg, num_levels=1, device="cpu")["decoded"]
    np.testing.assert_array_equal(native.read_tga("limg_decoded.tga"), want)


def test_decode_ltp1_and_bad_flags_exit(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--decode-ltp1"])
    assert e.value.code == 1 and "needs a stream path" in capsys.readouterr().out
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
