"""CLI of the port, with the flags of ``limg_tpu.cli``.

Usage:
    python -m limg_tpu_torch.cli <image> [--no-output] [--error-factor N]
                                 [--accurate-bit-crushing] [--fast-coalesce]
                                 [--rd-merge] [--fixed-grid] [--factors N]
                                 [--write-ltp1 FILE] [--diagnose]
                                 [--device cuda|cpu]
    python -m limg_tpu_torch.cli <stream.ltp1> --decode-ltp1
    python -m limg_tpu_torch.cli --decode-ltp1 <stream.ltp1>
    python -m limg_tpu_torch.cli -- [--count N] [--error-factor N]
                                 [--device cuda|cpu] -- <files...>

Single-image mode runs the merged (blocked) encoder with run coalescing
(the JAX CLI's default; ``--rd-merge`` takes the RD merge policy instead of
the match policy; ``--fast-coalesce`` pins the run buffer at NB/8, which
may truncate runs, instead of the auto capacity) or with ``--fixed-grid``
the fixed-grid encoder, prints the reference's stats and writes the debug
TGA planes unless ``--no-output``. ``--write-ltp1 FILE`` also writes the
LTP1 stream of the encode that ran; ``--diagnose`` prints the culprit
breakdown of that encode (regions of the merged encode, or blocks of a
fixed-grid refit). ``--decode-ltp1`` decodes a stream on the host into
``limg_decoded.tga``. List mode (``--``) is the throughput harness over
files (``--count N`` with one file gives the statistical perf report).
Images load through PIL, or from ``.npy`` arrays of (H, W, 3|4) uint8
where PIL is missing. ``--device`` defaults to cuda and never falls back
to the CPU.

``--fixed-grid --write-ltp1`` writes the stream of a 1-level merged encode
(the dense path, with run coalescing), as ``limg_tpu.cli`` does: the
fixed grid is the one encode an LTP1 stream of one level holds.
"""

from __future__ import annotations

import sys
import time

import numpy as np

def _parse_args(argv):
    opts = dict(write_output=True, error_factor=100, accurate=False, fixed_grid=False,
                count=1, files=[], source=None, list_mode=False, num_factors=3,
                device="cuda", cap_frac=0, merge_policy="match", diagnose=False,
                write_ltp1=None, decode_ltp1=None)
    if not argv:
        print(__doc__)
        sys.exit(0)
    if argv[0] == "--decode-ltp1":
        # flag-first order: the stream path follows the flag
        if len(argv) < 2:
            print("--decode-ltp1 needs a stream path. Aborting.")
            sys.exit(1)
        opts["decode_ltp1"] = argv[1]
        opts["source"] = argv[1]
        return opts
    opts["source"] = argv[0]
    if argv[0] == "--":
        opts["list_mode"] = True
        opts["write_output"] = False
    i = 1
    while i < len(argv):
        a = argv[i]
        if a == "--no-output":
            opts["write_output"] = False
        elif a == "--accurate-bit-crushing":
            opts["accurate"] = True
        elif a == "--single-thread":
            pass  # parity no-op
        elif a == "--fast-coalesce":
            # the latency-bounded run buffer (NB/8; may truncate) instead of
            # auto capacity
            opts["cap_frac"] = 8
        elif a == "--fixed-grid":
            opts["fixed_grid"] = True
        elif a == "--rd-merge":
            opts["merge_policy"] = "rd"
        elif a in ("--use-pallas", "--no-pallas"):
            print(f"{a}: the port selects its kernels with --device cuda|cpu. Aborting.")
            sys.exit(1)
        elif a == "--diagnose":
            opts["diagnose"] = True
        elif a == "--write-ltp1":
            i += 1
            opts["write_ltp1"] = argv[i]
        elif a == "--decode-ltp1":
            opts["decode_ltp1"] = opts["source"]
        elif a == "--error-factor":
            i += 1
            opts["error_factor"] = int(argv[i])
        elif a == "--factors":
            i += 1
            opts["num_factors"] = int(argv[i])
            if opts["num_factors"] not in (1, 2, 3):
                print("--factors must be 1, 2 or 3. Aborting.")
                sys.exit(1)
        elif a == "--count":
            i += 1
            opts["count"] = int(argv[i])
        elif a == "--device":
            i += 1
            opts["device"] = argv[i]
            if opts["device"] not in ("cuda", "cpu"):
                print("--device must be cuda or cpu. Aborting.")
                sys.exit(1)
        elif a == "--":
            opts["files"] = argv[i + 1:]
            i = len(argv)
        else:
            print(f"Invalid Parameter: '{a}'. Aborting.")
            sys.exit(1)
        i += 1
    return opts


def load_any(path: str):
    """(H, W, 4) uint8 RGBA + has_alpha, from a .npy array or via PIL."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
            raise ValueError(f"{path}: expected (H, W, 3|4) uint8, got {img.shape} {img.dtype}")
        if img.shape[2] == 4:
            return img, True
        return np.concatenate([img, np.full((*img.shape[:2], 1), 255, np.uint8)], -1), False
    from .io import load_image

    return load_image(path)


def _print_stats(out):
    hist = out["bits_histogram"]
    total_px = hist[0].sum()
    per_axis = [(8 - np.arange(9)) @ hist[i] / total_px for i in range(3)]
    print("\nAverage Block Bits: %5.3f (A: %5.3f | B: %5.3f | C: %5.3f)\n"
          % (sum(per_axis), *per_axis))
    print("".join(" %d bit   " % (8 - i) for i in range(9)))
    for i in range(3):
        print("".join("%7.4f  " % (hist[i][j] * 100.0 / total_px) for j in range(9)))
    print()
    print("Compression Average: ~%7.4f bits per pixel\n" % out["mean_bpp"])


def _hash_color(v: int) -> int:
    """Block-index visualization hash (limg_tpu/cli.py:46; reference:
    src/main.cpp:47-55)."""
    state = (v * 6364136223846793005 + (v | 1)) & 0xFFFFFFFFFFFFFFFF
    xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
    rot = state >> 59
    return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & 0xFFFFFFFF


def _endpoint_planes(rows, ch: int, h: int, w: int) -> dict:
    """Merged encode's (6ch, NB) endpoint rows -> the six endpoint-colour
    RGBA planes, +0x80 on B/C (limg_tpu/cli.py:271-287)."""
    by, bx = -(-h // 8), -(-w // 8)
    names = ["col_a_min", "col_a_max", "col_b_min", "col_b_max", "col_c_min", "col_c_max"]
    planes = {}
    for j, name in enumerate(names):
        bias = 0 if j < 2 else 0x80
        v = np.clip(rows[j * ch:(j + 1) * ch] + bias, 0, 255).astype(np.uint8).reshape(ch, by, bx)
        px_plane = np.repeat(np.repeat(v, 8, axis=1), 8, axis=2)
        rgba = np.full((h, w, 4), 0xFF, np.uint8)
        rgba[..., :ch] = px_plane[:, :h, :w].transpose(1, 2, 0)
        planes[name] = rgba
    return planes


def _region_plane(region_id: np.ndarray) -> np.ndarray:
    """(H, W) region ids -> RGBA plane of hashed colours."""
    ids = region_id.astype(np.int64)
    uniq, inv = np.unique(ids, return_inverse=True)
    cols = np.array([_hash_color(int(u)) | 0xFF000000 for u in uniq], np.uint64)
    rgba = cols[inv].reshape(ids.shape)
    hashed = np.zeros((*ids.shape, 4), np.uint8)
    for k in range(3):
        hashed[..., k] = (rgba >> (8 * k)) & 0xFF
    hashed[..., 3] = 0xFF
    return hashed


def _write_planes(out, h, w, channels: int):
    """The debug TGA planes: 12 for the fixed grid, 13 (with the hashed
    region plane) for the merged encode."""
    from .io import write_tga

    write_tga("limg_out.tga", out["decoded"])
    print("Wrote decoded file.")
    merged = "factors" in out
    for k, axis in enumerate("abc"):
        write_tga(f"limg_fac_{axis}.tga",
                  out["factors"][..., k] if merged else out[f"factors_{axis}"])
    write_tga("limg_bpp.tga", out["bpp"].astype(np.uint8))
    planes = (_endpoint_planes(out["endpoint_rows"], channels, h, w) if merged
              else out["endpoint_planes"])
    for name, plane in planes.items():
        write_tga(f"limg_{name}.tga", plane)
    # shift plane as bit patterns (reference: src/limg.cpp:1596-1598)
    patt = np.array([0, 0x22, 0x44, 0x66, 0x88, 0xAA, 0xCC, 0xEE, 0xFF], np.uint8)
    sh = out["shift"].transpose(1, 2, 0) if merged else out["shift"]
    bits_rgba = np.zeros((h, w, 4), np.uint8)
    for k in range(3):
        bits_rgba[..., k] = patt[np.minimum(sh[..., k], 8)]
    bits_rgba[..., 3] = 0xFF
    write_tga("limg_bits.tga", bits_rgba)
    if merged:
        write_tga("limg_block_idx.tga", _region_plane(out["region_id"]))


def main(argv=None):
    from .config import EncodeConfig
    from .encoder import encode_image, resolve_device
    from .ops.error import max_possible_error
    from .regions import encode_image_merged

    opts = _parse_args(argv if argv is not None else sys.argv[1:])
    if opts["decode_ltp1"]:
        _decode_ltp1(opts["decode_ltp1"])
        return
    crush_mode = "exhaustive" if opts["accurate"] else "ladder"
    device = resolve_device(opts["device"])
    if opts["list_mode"]:
        _run_list_mode(opts, crush_mode, device)
        return

    image, has_alpha = load_any(opts["source"])
    h, w = image.shape[:2]
    print(f"{w} x {h} pixels.")
    cfg = EncodeConfig(
        error_factor=opts["error_factor"], has_alpha=has_alpha,
        crush_mode=crush_mode if opts["error_factor"] else "none",
        num_factors=opts["num_factors"],
    )
    ser_state = None
    before = time.perf_counter()
    if opts["fixed_grid"]:
        out = encode_image(image, cfg, device=device)
    elif opts["write_ltp1"] or opts["diagnose"]:
        # one encode serves the stats, the stream and the diagnostics
        out, ser_state = encode_image_merged(image, cfg, merge_policy=opts["merge_policy"],
                                             return_state=True, cap_frac=opts["cap_frac"],
                                             device=device)
    else:
        out = encode_image_merged(image, cfg, merge_policy=opts["merge_policy"],
                                  cap_frac=opts["cap_frac"], device=device)
    elapsed = time.perf_counter() - before

    print(f"limg_tpu_torch encode completed on {device}.")
    print(f"Elapsed Time: {elapsed * 1e3:f} ms (incl. kernel build on first run)")
    print(f"Throughput: {w * h * 1e-6 / elapsed:f} Mpx/s")
    _print_stats(out)
    mean = out["mse"]
    mx = max_possible_error(cfg.channels)
    print("\nImage Perceptual RGB(A) PSNR: %4.2f dB (mean: %5.3f => %7.5f%% | sqrt: %5.3f%%)\n"
          % (out["psnr"], mean, mean / mx * 100.0, np.sqrt(mean) / np.sqrt(mx) * 100.0))
    if opts["diagnose"]:
        _diagnose(image, cfg, out, ser_state, device)
    if opts["write_ltp1"]:
        from .bitstream import serialize, serialize_from_state

        if ser_state is not None:
            # the stream represents exactly the encode reported above
            blob = serialize_from_state(ser_state, cfg)
        else:
            # the fixed grid: a 1-level merged encode (limg_tpu/cli.py:243-247)
            blob = serialize(image, cfg, num_levels=1, merge_policy=opts["merge_policy"],
                             device=device)
        with open(opts["write_ltp1"], "wb") as f:
            f.write(blob)
        print("Wrote %s: %d bytes = %.4f real bits per pixel (the reference has no "
              "bitstream; its number above is an estimate)."
              % (opts["write_ltp1"], len(blob), len(blob) * 8.0 / (w * h)))
    if opts["write_output"]:
        _write_planes(out, h, w, cfg.channels)


def _decode_ltp1(path: str):
    """Decode an LTP1 stream on the host into limg_decoded.tga."""
    from .bitstream import deserialize
    from .io import write_tga

    with open(path, "rb") as f:
        dec, info = deserialize(f.read())
    print(f"{info['width']} x {info['height']} pixels, "
          f"{info['levels']} levels, errorFactor {info['error_factor']}, "
          f"real {info['real_bpp']:.3f} bits per pixel.")
    write_tga("limg_decoded.tga", dec)
    print("Wrote limg_decoded.tga.")


def _diagnose(image, cfg, out, ser_state, device):
    """Culprit breakdown of the encode that ran (reference debug builds,
    src/limg.cpp:2412-2428): per region of the merged encode, from its
    state, or per block of a fixed-grid refit on ``device``."""
    from .utils.diagnostics import crush_culprits, crush_culprits_merged, format_culprits

    if ser_state is not None:
        culprits = crush_culprits_merged(image, ser_state, cfg, device=device)
        merge_stats = out.get("merge_stats")
    else:
        from .encoder import _as_image_tensor
        from .ops import layout
        from .ops.crush import find_shifts
        from .ops.factors import extract_factors, quantize_factors
        from .ops.fit import fit_blocks

        px, mask, _ = layout.blockify(_as_image_tensor(image, device))
        d = fit_blocks(px, mask, cfg.channels)
        f8 = quantize_factors(*extract_factors(px, d, cfg.channels))
        shifts, _ = find_shifts(px, mask, f8, d, cfg)
        culprits = crush_culprits(px, mask, f8, d, shifts, cfg)
        merge_stats = None
    print(format_culprits(culprits, merge_stats, out.get("coalesce_stats")))


def _run_list_mode(opts, crush_mode, device):
    import torch
    from .config import EncodeConfig
    from .encoder import encode_perf_step
    from .utils.timing import time_device_fn

    files = opts["files"]
    if not files:
        print("no files given after --")
        sys.exit(1)
    single_perf = len(files) == 1 and opts["count"] > 1
    total_px = total_s = 0.0
    for path in files:
        image, has_alpha = load_any(path)
        cfg = EncodeConfig(error_factor=opts["error_factor"], has_alpha=has_alpha,
                           crush_mode=crush_mode, num_factors=opts["num_factors"])
        img_d = torch.from_numpy(image).to(device)
        mpx = image.shape[0] * image.shape[1] * 1e-6

        def step():
            return encode_perf_step(img_d, cfg, 0, device)

        if single_perf:
            inner = 4
            per, det = time_device_fn(step, device=device,
                                      iters=opts["count"] * inner, inner=inner)
            mn, mx, sd = det["best_s"], det["worst_s"], det["std_s"]
            print("Mean Elapsed Time: %8.4f ms (%8.4f - %8.4f ms | %8.4f - %8.4f ms std dev)"
                  % (per * 1e3, mn * 1e3, mx * 1e3, (per - sd) * 1e3, (per + sd) * 1e3))
            print("Throughput: %5.3f Mpx/s (%5.3f - %5.3f Mpx/s | %5.3f - %5.3f Mpx/s std dev)"
                  % (mpx / per, mpx / mx, mpx / mn, mpx / (per + sd), mpx / max(per - sd, 1e-9)))
        else:
            per, _ = time_device_fn(step, device=device, iters=opts["count"] * 2, inner=2)
            total_px += mpx * opts["count"]
            total_s += per * opts["count"]
    if not single_perf:
        print("\rComplete.   \nProcessed %5.3f Mpx in %5.3f sec on %s\nThroughput: %8.5f MPx/s\n"
              % (total_px, total_s, device, total_px / total_s))


if __name__ == "__main__":
    main()
