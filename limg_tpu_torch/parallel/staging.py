"""Uploads from host memory to a card through reusable pinned buffers.

``tensor.to(card)`` from pageable host memory returns only after the calling
thread has copied every byte into CUDA's own staging memory, so shards
uploaded one after another are paced by one thread's memory copy. Here a
shard's bytes go to its card in chunks of at most ``CHUNK_BYTES``: each chunk
is copied on the host into one of the card's ``RING`` pinned buffers
(``Tensor.copy_``, which spreads over the intra-op threads and releases the
GIL) and from there to the card asynchronously, on the stream that was
current for the card where the upload started. A buffer is refilled only
after the copy out of it has completed (one event a buffer). Each card has
its own worker thread, so ``start`` returns at once and the cards' host
copies run at the same time; the future ``start`` returns holds the shard
once every copy of it is enqueued, so work enqueued after that on the stream
follows them.

A card's buffers, events and worker are made on its first upload and kept for
the process: ``RING * CHUNK_BYTES`` of pinned memory a card. Every upload
copies every byte it is given; nothing is kept of a source between uploads.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor

import torch

CHUNK_BYTES = 64 << 20
RING = 2


def staged(src: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``src`` goes to ``dev`` through pinned buffers: from host
    memory to a CUDA card."""
    return src.device.type == "cpu" and dev.type == "cuda"


def _walk(src: torch.Tensor, dst: torch.Tensor, ring: list, events: list | None = None):
    """Copy the 1-D ``src`` into the 1-D ``dst`` (uint8, same length) chunk by
    chunk, each through the next buffer of ``ring`` (1-D uint8 buffers of one
    length, the chunk's). With ``events``, one a buffer, the copy out of a
    buffer is asynchronous and the buffer is refilled only after it has
    completed; without, every copy is synchronous (buffers and ``dst`` in
    host memory)."""
    size = ring[0].numel()
    for i, begin in enumerate(range(0, src.numel(), size)):
        slot = i % len(ring)
        end = min(begin + size, src.numel())
        if events is not None and not events[slot].query():
            events[slot].synchronize()
        buf = ring[slot][:end - begin]
        buf.copy_(src[begin:end])
        dst[begin:end].copy_(buf, non_blocking=events is not None)
        if events is not None:
            events[slot].record()


class _Card:
    """A card's pinned buffers, their events and its upload worker."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        with torch.cuda.device(dev):
            self.ring = [torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                         for _ in range(RING)]
            self.events = [torch.cuda.Event() for _ in range(RING)]
        # one thread: a card's uploads take its buffers one after another
        self.worker = ThreadPoolExecutor(1, thread_name_prefix=f"limg-upload-{dev.index}")

    def copy(self, src: torch.Tensor, dst: torch.Tensor, stream: torch.cuda.Stream):
        with torch.cuda.device(self.dev), torch.cuda.stream(stream):
            _walk(src.view(-1), dst.view(-1), self.ring, self.events)
        return dst


_cards: dict[int, _Card] = {}
_cards_lock = threading.Lock()


def _card(dev: torch.device) -> _Card:
    with _cards_lock:
        if dev.index not in _cards:
            _cards[dev.index] = _Card(dev)
        return _cards[dev.index]


def start(src: torch.Tensor, dev: torch.device) -> Future:
    """Start uploading the uint8 host tensor ``src`` to the CUDA card ``dev``
    (``staged(src, dev)``) through its pinned buffers. The future's result is
    the shard on ``dev``, once every copy of it is enqueued on the stream
    current for ``dev`` here."""
    card = _card(dev)
    src = src.contiguous()
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    return card.worker.submit(card.copy, src, dst, torch.cuda.current_stream(dev))
