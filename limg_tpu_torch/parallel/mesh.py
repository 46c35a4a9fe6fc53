"""Corpus and multi-device encode over a mesh of devices driven by one process.

The counterpart of ``limg_tpu/parallel/mesh.py``. JAX's ``shard_map`` over
a ``Mesh`` has one controller: one call drives every device and returns
host values. Here a mesh is a tuple of ``torch.device``s (``make_mesh``).
Each shard's work is enqueued on its own device before anything is read
back (every kernel wrapper launches on its input's device and that
device's current stream), so on several cards the shards run at once from
one host thread. The one collective, JAX's ``psum`` of a scalar, is
``_psum``. On the CPU a mesh of n entries of ``cpu`` stands in for XLA's
virtual host devices: the shards run one after another through the
kernels' plain versions.

- intra-image (``encode_image_blocks_sharded``): the block axis is split
  over the mesh; every encode stage is per block, so only the stats are
  reduced.
- inter-image (``encode_corpus_sharded``, ``_merged``, ``_mixed``): the
  images are split over the mesh; a fixed-grid shard is one kernel launch
  over its images concatenated on the block axis.

Seeds: image i of a corpus encoded with ``seed`` draws its dither from
``image_seed(seed, i)``, and a fixed-grid shard, one launch, from its first
image's. The JAX package splits a threefry key instead, so with dithering
on the two agree statistically only, and exactly with it off.

Spans and counters (``utils/diagnostics``): an entry's body is a span named
after it (``limg.encode_corpus_sharded``, ``_merged``, ``_mixed``); inside
it each shard's ``limg.corpus.upload`` and, on the fixed grid,
``limg.corpus.blockify``, ``.encode`` and ``.stats``, then the call's
``limg.corpus.gather`` and ``limg.fetch``. Each shard counts its images,
``limg.corpus.frames``, and the bytes it sent from host memory to a card,
``limg.corpus.upload_bytes``, both host ints.

Uploads: a shard in host memory bound for a CUDA card goes through that
card's pinned buffers (``staging``), and counts those bytes as
``limg.corpus.staged_bytes``; the fixed-grid and merged corpus encodes start
every shard's upload at once, each card's on its own worker, and enqueue a
shard's work once its copies are enqueued. Any other shard (already on a
card, or bound for the CPU) is moved by ``.to``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os

import numpy as np
import torch

# the fixed grid's kernel is called as ``encoder.encode_blocks_kernel``, so
# that every fixed-grid path (the image, the corpus, the block shards) runs
# the kernel the encoder runs
from .. import encoder, native
from ..config import EncodeConfig, static_block_bits
from ..encoder import _as_image_tensor, _packed_blocks
from ..io import load_image
from ..ops import layout
from ..ops.dither import image_seed
from ..ops.error import max_possible_error
from ..regions import encode_image_merged_device, encode_image_merged_fused_device
from ..utils.diagnostics import count, span
from . import staging


def make_mesh(n_devices: int | None = None, device="cuda") -> tuple[torch.device, ...]:
    """The devices of an ``n_devices`` mesh (limg_tpu/parallel/mesh.py:31).

    CUDA: ``cuda:0`` ... ``cuda:n-1`` (None: every visible card); raises
    RuntimeError when fewer cards are visible. CPU: ``n_devices`` entries of
    ``cpu`` (None: one), the counterpart of XLA's virtual host devices.
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got n_devices={n_devices}")
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind} devices: pass device='cuda' or 'cpu'")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or max(visible, 1)
    if visible < n:
        raise RuntimeError(f"requested a {n}-device mesh but only {visible} device(s) are "
                           "visible (cuda); for a virtual CPU mesh pass device='cpu'")
    return tuple(torch.device("cuda", i) for i in range(n))


def _on(dev: torch.device):
    """Make ``dev`` the current card while a shard's work is enqueued."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _psum(parts, mesh) -> torch.Tensor:
    """JAX's ``psum`` of per-shard scalars: each copied to ``mesh[0]`` and
    added there in shard order. In float64, where JAX adds float32: the
    partials are integer counts and sums of a shard's float32 PSNRs, which
    float64 holds exactly, so the CPU and the card give the same total."""
    total = parts[0].to(mesh[0], torch.float64)
    for part in parts[1:]:
        total = total + part.to(mesh[0], torch.float64)
    return total


def _per_pixel(total: torch.Tensor, npx) -> torch.Tensor:
    """``total / npx`` as JAX's programs compute it: by a tensor ``npx``
    (counted on the device) a quotient, by a Python int (a constant of the
    program) a product with its reciprocal, which XLA folds in; both in
    ``total``'s dtype."""
    if isinstance(npx, torch.Tensor):
        return total / npx.to(total.dtype)
    recip = (torch.ones((), dtype=total.dtype) / npx).item()     # on the host
    return total * torch.full((), recip, dtype=total.dtype, device=total.device)


def _psnr(err: torch.Tensor, npx, channels: int) -> torch.Tensor:
    """float32 weighted PSNR of a total error over ``npx`` pixels
    (limg_tpu/parallel/mesh.py:110-111), computed in float64."""
    mse = _per_pixel(err.to(torch.float64), npx)
    psnr = 10.0 * torch.log10(max_possible_error(channels) / torch.clamp(mse, min=1e-12))
    return psnr.to(torch.float32)


def _image_stats(err: torch.Tensor, bits: torch.Tensor, npx, nb: int, channels: int):
    """(psnr, bpp) of images from their error totals and factor bits: bpp
    counts every block's static header (limg_tpu/parallel/mesh.py:113-116)
    and is JAX's float32 bit for bit."""
    total = (bits + static_block_bits(channels) * nb).to(torch.float32)
    return _psnr(err, npx, channels), _per_pixel(total, npx)


def _factor_bits(shifts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(3, NB) shifts and (64, NB) mask -> (3, NB) int64 factor bits."""
    return (8 - torch.clamp(shifts, max=8)) * mask.sum(dim=0)


def _as_batch(images) -> torch.Tensor:
    """(N, H, W, 3|4) uint8 NumPy array or tensor -> tensor, not moved."""
    if isinstance(images, np.ndarray):
        images = np.ascontiguousarray(images)
        images = torch.from_numpy(images if images.flags.writeable else images.copy())
    if (images.dtype != torch.uint8 or images.ndim != 4 or images.shape[0] == 0
            or images.shape[3] not in (3, 4)):
        raise ValueError(f"expected (N >= 1, H, W, 3|4) uint8, got "
                         f"{tuple(images.shape)} {images.dtype}")
    return images


def _shard_size(n: int, mesh) -> int:
    if n % len(mesh):
        raise ValueError(f"{n} images do not split evenly over a {len(mesh)}-device mesh")
    return n // len(mesh)


# a corpus call's staged uploads, started for every shard at once:
# (its batch, {(shard index, device): the future of the shard on the device})
_started = contextvars.ContextVar("limg_corpus_started", default=None)


@contextlib.contextmanager
def _start_uploads(batch: torch.Tensor, n_loc: int, mesh):
    """Start the staged upload of every shard of ``batch`` at once, each on
    its card's worker; inside, ``_upload`` takes the one of its shard and
    device. On leaving, waits for any that no shard took."""
    ups = {(k, dev): staging.start(batch[k * n_loc:(k + 1) * n_loc], dev)
           for k, dev in enumerate(mesh) if staging.staged(batch, dev)}
    token = _started.set((batch, ups))
    try:
        yield
    finally:
        _started.reset(token)
        for up in ups.values():
            up.result()


def _upload(batch: torch.Tensor, k: int, n_loc: int, dev: torch.device) -> torch.Tensor:
    """Shard ``k`` of ``batch`` (``n_loc`` images) on ``dev``, its copies
    enqueued on the device's current stream. Counts its images
    (``limg.corpus.frames``), the bytes it sent from host memory to a device
    that is not the CPU (``limg.corpus.upload_bytes``) and, of those, the
    bytes that went through pinned buffers (``limg.corpus.staged_bytes``)."""
    src = batch[k * n_loc:(k + 1) * n_loc]
    staged = staging.staged(src, dev)
    with span("limg.corpus.upload"):
        if staged:
            started = _started.get()
            up = started[1].pop((k, dev), None) if started and started[0] is batch else None
            shard = (up or staging.start(src, dev)).result()
        else:
            shard = src.to(dev, non_blocking=True)
    count("limg.corpus.frames", n_loc)
    count("limg.corpus.upload_bytes",
          shard.nbytes if batch.device.type == "cpu" and dev.type != "cpu" else 0)
    if staged:
        count("limg.corpus.staged_bytes", shard.nbytes)
    return shard


def _corpus_shard(imgs: torch.Tensor, cfg: EncodeConfig, seed: int):
    """One fixed-grid shard: its (n, H, W, C) images, on one device, in one
    kernel launch over their blocks concatenated on the block axis
    (limg_tpu/parallel/mesh.py:86-118). Returns per-image (psnr, bpp)."""
    n, h, w = imgs.shape[:3]
    with span("limg.corpus.blockify"):
        blocks = [_packed_blocks(im) for im in imgs]
        nb = blocks[0][2].num_blocks
        packed = torch.cat([b[0] for b in blocks], dim=1)
        mask = torch.cat([b[1] for b in blocks], dim=1)
    with span("limg.corpus.encode"):
        shifts, _, _, dist = encoder.encode_blocks_kernel(packed, mask, cfg, seed)[:4]
    with span("limg.corpus.stats"):
        err = dist[0].to(torch.float64).reshape(n, nb).sum(dim=1)
        bits = _factor_bits(shifts, mask).reshape(3, n, nb).sum(dim=(0, 2))
        return _image_stats(err, bits, h * w, nb, cfg.channels)


def _gather(parts, mesh, n: int):
    """Per-shard (psnr, bpp) -> the corpus's on ``mesh[0]`` and its mean PSNR."""
    psnr = torch.cat([p.to(mesh[0]) for p, _ in parts])
    bpp = torch.cat([b.to(mesh[0]) for _, b in parts])
    total = _psum([p.to(torch.float64).sum() for p, _ in parts], mesh)
    return psnr, bpp, total / torch.full((), n, dtype=torch.float64, device=mesh[0])


def _fetch(psnr, bpp, mean_psnr) -> dict:
    return {"psnr": psnr.cpu().numpy(), "bpp": bpp.cpu().numpy(),
            "mean_psnr": float(mean_psnr)}


def _corpus_sharded(images, cfg: EncodeConfig, mesh, seed: int):
    """``encode_corpus_sharded`` up to the fetch: (psnr, bpp, mean_psnr) on
    ``mesh[0]``."""
    imgs = _as_batch(images)
    n = imgs.shape[0]
    n_loc = _shard_size(n, mesh)
    parts = []
    with _start_uploads(imgs, n_loc, mesh):
        for k, dev in enumerate(mesh):
            with _on(dev):
                shard = _upload(imgs, k, n_loc, dev)
                parts.append(_corpus_shard(shard, cfg, image_seed(seed, k * n_loc)))
    with span("limg.corpus.gather"):
        return _gather(parts, mesh, n)


def encode_corpus_sharded(images, cfg: EncodeConfig, n_devices: int | None = None,
                          seed: int = 0, device="cuda") -> dict:
    """Encode a batch of same-shape images sharded over a device mesh
    (limg_tpu/parallel/mesh.py:61, its ``use_pallas=True`` route).

    ``images``: (N, H, W, C) uint8, N divisible by the mesh size. Each
    shard's images go through the fixed-grid kernel in one launch. Returns
    per-image ``psnr`` and ``bpp`` (float32 NumPy) and the corpus-mean PSNR
    ``mean_psnr`` (a ``_psum`` over the shards).
    """
    with span("limg.encode_corpus_sharded"):
        out = _corpus_sharded(images, cfg, make_mesh(n_devices, device), seed)
        with span("limg.fetch"):
            return _fetch(*out)


def encode_corpus_sharded_merged(images, cfg: EncodeConfig, n_devices: int | None = None,
                                 seed: int = 0, num_levels: int = 3, coalesce: bool = True,
                                 fused: bool = True, device="cuda") -> dict:
    """Corpus encode with the merged encoder (quadtree merge and run
    coalescing) sharded over a device mesh (limg_tpu/parallel/mesh.py:141).

    Same contract as ``encode_corpus_sharded``; each image runs
    ``encode_image_merged_fused_device`` (``fused``, JAX's ``use_pallas``)
    or the dense ``encode_image_merged_device`` at their default run
    capacity (``cap_frac=8``) without planes, on its shard's device.
    """
    encode = encode_image_merged_fused_device if fused else encode_image_merged_device
    with span("limg.encode_corpus_sharded_merged"):
        mesh = make_mesh(n_devices, device)
        imgs = _as_batch(images)
        n, h, w = imgs.shape[:3]
        n_loc = _shard_size(n, mesh)
        parts = []
        with _start_uploads(imgs, n_loc, mesh):
            for k, dev in enumerate(mesh):
                with _on(dev):
                    shard = _upload(imgs, k, n_loc, dev)
                    outs = [encode(im, cfg, image_seed(seed, k * n_loc + j), num_levels,
                                   emit_planes=False, coalesce=coalesce, device=dev)
                            for j, im in enumerate(shard)]
                    parts.append((torch.stack([_psnr(o["total_err"], h * w, cfg.channels)
                                               for o in outs]),
                                  torch.stack([o["mean_bpp"] for o in outs]).to(torch.float32)))
        with span("limg.corpus.gather"):
            out = _gather(parts, mesh, n)
        with span("limg.fetch"):
            return _fetch(*out)


def _read_image(path) -> np.ndarray:
    """An image file -> (H, W, 4) uint8 RGBA: TGA by the host runtime's
    reader (its NumPy fallback needs no PIL), any other format by PIL."""
    path = os.fspath(path)
    if path.lower().endswith(".tga"):
        return native.read_tga(path)
    return load_image(path)[0]


def encode_corpus_sharded_mixed(images, cfg: EncodeConfig, n_devices: int | None = None,
                                seed: int = 0, device="cuda") -> dict:
    """Mixed-size corpus encode: bucket by shape, shard each bucket
    (limg_tpu/parallel/mesh.py:210).

    ``images``: a list of (H, W, C) uint8 arrays and/or file paths (read as
    RGBA). Each (H, W, C) bucket is padded to a multiple of the mesh size
    by repeating its last image and encoded as ``encode_corpus_sharded``;
    the pad entries are dropped, so per-image stats and the mean are exact.
    Returns per-image ``psnr`` / ``bpp`` in input order, ``mean_psnr`` and
    ``buckets`` (images per shape).
    """
    with span("limg.encode_corpus_sharded_mixed"):
        arrs = [_read_image(im) if isinstance(im, (str, os.PathLike)) else np.asarray(im)
                for im in images]
        buckets: dict[tuple, list[int]] = {}
        for i, a in enumerate(arrs):
            buckets.setdefault(a.shape, []).append(i)
        mesh = make_mesh(n_devices, device)
        outs = []
        for _, idxs in sorted(buckets.items()):
            batch = np.stack([arrs[i] for i in idxs])
            pad = (-len(idxs)) % len(mesh)
            if pad:
                batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
            outs.append((idxs, _corpus_sharded(batch, cfg, mesh, seed)))
        psnr = np.zeros(len(arrs), np.float64)
        bpp = np.zeros(len(arrs), np.float64)
        with span("limg.fetch"):
            for idxs, (p, b, _) in outs:
                psnr[idxs] = p.cpu().numpy()[: len(idxs)]
                bpp[idxs] = b.cpu().numpy()[: len(idxs)]
        return {"psnr": psnr, "bpp": bpp, "mean_psnr": float(psnr.mean()) if len(arrs) else 0.0,
                "buckets": {str(k): len(v) for k, v in buckets.items()}}


def _blocks_sharded(image, cfg: EncodeConfig, mesh, seed: int):
    """``encode_image_blocks_sharded`` up to the fetch: the (64, NB) packed
    decode on ``mesh[0]``, the error and factor-bit totals, the grid."""
    packed, mask, grid = _packed_blocks(_as_image_tensor(image, mesh[0]))
    nb = grid.num_blocks
    pad = (-nb) % len(mesh)
    if pad:   # padded blocks: no pixel, so no error and no bits
        packed = torch.cat([packed, packed.new_zeros((packed.shape[0], pad))], dim=1)
        mask = torch.cat([mask, mask.new_zeros((mask.shape[0], pad))], dim=1)
    n_s = (nb + pad) // len(mesh)
    decs, errs, bits = [], [], []
    for k, dev in enumerate(mesh):
        with _on(dev):
            m = mask[:, k * n_s:(k + 1) * n_s].to(dev)
            shifts, _, dec, dist = encoder.encode_blocks_kernel(
                packed[:, k * n_s:(k + 1) * n_s].to(dev), m, cfg, seed)[:4]
            decs.append(dec)
            errs.append(dist.to(torch.float64).sum())
            bits.append(_factor_bits(shifts, m).sum())
    dec = torch.cat([d.to(mesh[0]) for d in decs], dim=1)[:, :nb]
    return dec, _psum(errs, mesh), _psum(bits, mesh), grid


def _blocks_fetch(dec: torch.Tensor, err: torch.Tensor, bits: torch.Tensor,
                  grid: layout.BlockGrid, cfg: EncodeConfig):
    """``_blocks_sharded``'s outputs -> (decoded (H, W, ch) uint8 NumPy,
    psnr, bpp) by limg_tpu/parallel/mesh.py:330-336."""
    ch = cfg.channels
    n = grid.height * grid.width
    psnr = 10.0 * math.log10(max_possible_error(ch) / max(float(err) / n, 1e-12))
    bpp = (float(bits) + static_block_bits(ch) * grid.num_blocks) / n
    planes = torch.stack([layout.unpack_plane(dec, c) for c in range(ch)]).to(torch.uint8)
    return layout.unblockify(planes, grid).cpu().numpy(), psnr, bpp


def encode_image_blocks_sharded(image, cfg: EncodeConfig, n_devices: int | None = None,
                                seed: int = 0, device="cuda"):
    """Single-image encode with the block axis sharded over a device mesh
    (limg_tpu/parallel/mesh.py:259, its ``use_pallas=True`` route).

    NB is padded to a multiple of the mesh size with empty blocks; each
    shard is one kernel launch with ``seed`` itself, so one shard's decode
    is ``encode_image``'s. Returns (decoded (H, W, ch) uint8 NumPy, psnr,
    bpp).
    """
    return _blocks_fetch(*_blocks_sharded(image, cfg, make_mesh(n_devices, device), seed), cfg)
