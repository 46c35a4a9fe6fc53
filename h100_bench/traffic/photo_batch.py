"""Batches of photo-like frames in host memory, made from a seed.

Parameters (``traffic/<name>.json``): ``frames`` a batch, ``height``,
``width``, ``pool`` distinct batches made at set-up, and the recipe's own
parameters (``photo.py``). Frame j of batch i is ``photo.py``'s image ``i *
frames + j`` under the run's seed, made on the first card given (the first
device of a tuple, or the one device); each batch is returned as one
C-contiguous, writeable (frames, height, width, 3) uint8 NumPy array in
pageable host memory, as a decoder hands frames over. Nothing is pinned.
"""

from __future__ import annotations

import numpy as np
import torch

from . import photo


def make_pool(params: dict, seed: int, device) -> list[np.ndarray]:
    first = device[0] if isinstance(device, tuple) else device
    frames, pool = int(params["frames"]), int(params["pool"])
    images = photo.make_pool(dict(params, pool=frames * pool), seed, first)
    return [torch.stack(images[i * frames:(i + 1) * frames]).cpu().numpy() for i in range(pool)]
