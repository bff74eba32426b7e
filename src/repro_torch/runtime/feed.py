"""DeviceFeed — host→device staging through a ring of pinned buffers.

The counterpart of ``repro.runtime.feed``. Keeping ``depth`` blocks in
flight lets the copy of block i+1 overlap the ingestion compute of block i,
the classic double-buffered pipeline (depth 2). On a CUDA device every
block goes through one of ``depth`` preallocated **pinned** host buffers
and is copied ``non_blocking`` on a side stream that records an event; the
consumer's stream waits on that event before it uses the block, and the
device tensor is ``record_stream``-ed onto the consumer's stream, so the
allocator keeps it until the consumer is done with it. A pinned slot is
written again only after its previous copy's event has completed. On the
CPU the stager is a plain FIFO.

The feed yields device tensors in input order; in a multi-rank runtime
each rank stages only its own rows of every block, so the block
decomposition is the scatter.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.spacesaving import EMPTY


def host_blocks(stream: np.ndarray, workers: int,
                multiple: int = 1) -> np.ndarray:
    """Host-side mirror of :func:`repro_torch.core.parallel.block_decompose`.

    Pads with EMPTY and reshapes to (workers, per) with numpy so staging
    never round-trips through a device. A final partial chunk is
    EMPTY-padded up to the ``multiple`` boundary (never dropped), and an
    empty stream decomposes to (workers, 0) — ``StreamRuntime.feed`` skips
    such blocks instead of staging them.
    """
    stream = np.asarray(stream)
    n = stream.shape[-1]
    per = -(-n // workers)
    per = -(-per // multiple) * multiple
    pad = per * workers - n
    if pad:
        stream = np.concatenate(
            [stream, np.full((pad,), EMPTY, stream.dtype)])
    return stream.reshape(workers, per)


def host_block_iter(chunks: Iterable, workers: int, multiple: int = 1, *,
                    block_items: int | None = None
                    ) -> Iterator[np.ndarray]:
    """Streaming :func:`host_blocks`: (workers, per) blocks from chunk pieces.

    Buffers incoming host chunks only up to one block — ``block_items``
    ids, rounded up to a full ``workers × multiple`` layer — then emits
    that segment through ``host_blocks`` and drops it, so an unbounded
    stream is decomposed with O(block) host memory. The trailing remainder
    is EMPTY-padded exactly like ``host_blocks`` (never dropped); every
    emitted block but the last has the same shape.
    """
    layer = workers * multiple
    if block_items is None:
        block_items = layer
    block_items = max(1, -(-block_items // layer)) * layer
    buf: list[np.ndarray] = []
    have = 0
    for chunk in chunks:
        arr = np.asarray(chunk).reshape(-1)
        while arr.size:
            take = min(arr.size, block_items - have)
            buf.append(arr[:take])
            have += take
            arr = arr[take:]
            if have == block_items:
                yield host_blocks(np.concatenate(buf), workers, multiple)
                buf, have = [], 0
    if have:
        yield host_blocks(np.concatenate(buf), workers, multiple)


def coalesce_blocks(payloads, workers: int, multiple: int = 1) -> np.ndarray:
    """One (workers, Σper) canonical block from several host payloads.

    Each payload is decomposed by :func:`host_blocks` independently (its
    EMPTY padding lands at ITS chunk boundary, exactly where a per-block
    ingest would put it) and the decompositions are concatenated along
    the stream axis, so ingesting the coalesced block once is bitwise
    identical to ingesting the payloads one at a time.
    """
    parts = [host_blocks(p, workers, multiple) for p in payloads]
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts, axis=-1)


class DeviceStager:
    """Push-mode staging: issue copies now, consume them later.

    ``stage()`` starts the host→device copy of one block at once and
    ``take()`` hands back the oldest staged device tensor in FIFO order.
    ``depth`` bounds how many copies may be in flight (``room`` is the
    caller's staging budget) and is the number of pinned host buffers. An
    optional ``meta`` tag rides along untouched (the serving tier's ingest
    loop uses it for block/item counts).
    """

    def __init__(self, *, device="cuda", depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = torch.device(device)
        self._queue: collections.deque = collections.deque()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pinned = [None] * depth     # uint8 pinned host buffers
            self._copied = [None] * depth     # the event of each slot's last copy
            self._slot = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def room(self) -> int:
        """How many more copies may be staged right now."""
        return max(0, self.depth - len(self._queue))

    def stage(self, block: np.ndarray, meta=None) -> torch.Tensor:
        """Start the host→device copy of one block."""
        block = np.ascontiguousarray(block)
        if self.device.type != "cuda":
            dev = torch.from_numpy(block).to(self.device)
            self._queue.append((dev, None, meta))
            return dev
        i = self._slot
        self._slot = (i + 1) % self.depth
        if self._copied[i] is not None:
            self._copied[i].synchronize()     # the slot's last copy has landed
        buf = self._pinned[i]
        if buf is None or buf.numel() < block.nbytes:
            buf = self._pinned[i] = torch.empty(block.nbytes, dtype=torch.uint8,
                                                pin_memory=True)
        host = torch.from_numpy(block)
        pinned = buf[:block.nbytes].view(host.dtype).view(host.shape)
        pinned.copy_(host)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            dev.copy_(pinned, non_blocking=True)
            copied = self._copied[i] = torch.cuda.Event()
            copied.record(self._stream)
        self._queue.append((dev, copied, meta))
        return dev

    def take(self):
        """The oldest staged ``(device tensor, meta)`` pair (FIFO), the
        tensor ready to use on the current stream."""
        dev, copied, meta = self._queue.popleft()
        if copied is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(copied)
            dev.record_stream(consumer)
        return dev, meta


class DeviceFeed:
    """Iterate host blocks as device tensors, ``depth`` copies in flight."""

    def __init__(self, blocks: Iterable, *, device="cuda", depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._blocks = blocks
        self._device = device
        self._depth = depth

    def __iter__(self) -> Iterator[torch.Tensor]:
        stager = DeviceStager(device=self._device, depth=self._depth)
        for block in self._blocks:
            stager.stage(block)
            if not stager.room:
                yield stager.take()[0]
        while len(stager):
            yield stager.take()[0]
