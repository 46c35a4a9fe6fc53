"""The corpus and block-sharded encodes over a mesh of every visible card,
against the same calls on one card.

    python3 tools/mesh_multicard.py [--out FILE.json]

Needs two CUDA cards or more and imports nothing of JAX. With dithering
off, a mesh of n cards must give the one-card mesh's per-image stats (the
fixed-grid corpus, the fused merged corpus) and decode (the block-sharded
4K image) bit for bit; the multichip dry run's three paths must land
inside MULTICHIP_EXPECTED.json at n cards. Then it times the fixed-grid
corpus of 8 x n images of 1080p and the block-sharded 4K image at 1 and n
cards: host wall from the call to the fetched result, every card's work
included, median of 10 after a warm-up. Prints one JSON line (also
written to ``--out``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 10


def wall_ms(fn, runs: int = RUNS) -> float:
    """Median host ms of ``fn()``, whose result is fetched to the host."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from limg_tpu_torch import EncodeConfig
    from limg_tpu_torch.kernels import launch
    from limg_tpu_torch.parallel import mesh
    from tools.record_torch_reference import case_images

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(f"needs two CUDA cards or more, sees {n}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"{n} cards: {smi}", flush=True)
    chip_smoke.phase_build()
    nodither = EncodeConfig(error_factor=100, dithering=False)
    images = chip_smoke.corpus_images(8 * n)
    img4k = case_images(2160, 3840)["rgb"]

    one = mesh.encode_corpus_sharded(images, nodither, n_devices=1)
    launch.reset_launches()
    many = mesh.encode_corpus_sharded(images, nodither, n_devices=n)
    if launch.launches["encode_fixed_p64"] != n:
        raise AssertionError(f"{n}-card corpus: {launch.launches['encode_fixed_p64']} launches, "
                             f"not {n}")
    for key in ("psnr", "bpp"):
        if not np.array_equal(one[key], many[key]):
            raise AssertionError(f"fixed-grid corpus: {key} on {n} cards differs from 1")
    merged = [mesh.encode_corpus_sharded_merged(images[:2 * n], nodither, n_devices=k)
              for k in (1, n)]
    for key in ("psnr", "bpp"):
        if not np.array_equal(merged[0][key], merged[1][key]):
            raise AssertionError(f"merged corpus: {key} on {n} cards differs from 1")
    blocks = [mesh.encode_image_blocks_sharded(img4k, nodither, n_devices=k) for k in (1, n)]
    if not (np.array_equal(blocks[0][0], blocks[1][0]) and blocks[0][1:] == blocks[1][1:]):
        raise AssertionError(f"block-sharded 4K image on {n} cards differs from 1")
    print(f"{n} cards: fixed-grid corpus ({8 * n} x 1080p, {n} launches), merged corpus "
          f"({2 * n} images) and block-sharded 4K image equal the one-card results", flush=True)
    gate = chip_smoke.multichip_gate(n, "cuda")

    dither = EncodeConfig(error_factor=100)
    result = {"cards": n, "smi": smi, "gate": gate, "corpus_images": 8 * n}
    for k in (1, n, n, 1):      # in turns, so both see the same cards
        corpus_ms = wall_ms(lambda: mesh.encode_corpus_sharded(images, dither, n_devices=k))
        blocks_ms = wall_ms(lambda: mesh.encode_image_blocks_sharded(img4k, dither, n_devices=k))
        result.setdefault(f"corpus_ms_{k}", []).append(corpus_ms)
        result.setdefault(f"blocks4k_ms_{k}", []).append(blocks_ms)
        print(f"  {k} card(s): fixed-grid corpus {8 * n} x 1080p {corpus_ms!r} ms "
              f"({8 * n * 1920 * 1080e-6 / corpus_ms * 1e3!r} Mpx/s), block-sharded 4K "
              f"{blocks_ms!r} ms (host wall with the fetch, median of {RUNS}) {smi}", flush=True)
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
