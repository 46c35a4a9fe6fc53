"""Batches of noise frames in host memory, made from a seed: a traffic of
the batch cell that the harness's own tests add (``tests/batch_cell/``).

    frames, height, width    one item is a (frames, height, width, 3) uint8 batch
    pool                     distinct batches made at set-up

It takes the tuple of the cell's cards and pins its batches' host memory
where they are cards, as a corpus sent from the host is held.
"""

from __future__ import annotations

import torch


def make_pool(params: dict, seed: int, devices: tuple) -> list:
    shape = (int(params["frames"]), int(params["height"]), int(params["width"]), 3)
    pool = []
    for i in range(int(params["pool"])):
        gen = torch.Generator().manual_seed((seed * 1000003 + i) % (1 << 63))
        batch = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        pool.append(batch.pin_memory() if devices[0].type == "cuda" else batch)
    return pool
