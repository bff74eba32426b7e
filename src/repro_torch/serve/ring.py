"""SnapshotRing — versioned, wait-free reads of the latest QuerySnapshot.

The counterpart of ``repro.serve.ring``: the serving tier's one hand-off
point between ingestion and queries (DESIGN.md §11), a fixed-depth ring of
immutable snapshots published by the single ingest thread and read
concurrently by any number of query threads, with no lock on either the
publish or the ``latest()`` path.

Why this is safe without a reader lock:

  * every slot holds a *complete immutable object*: nothing writes a
    published snapshot's tensors, so a reader sees either the previous
    snapshot or the new one, never a half-written hybrid;
  * ``publish`` stores the snapshot into its ring slot and then swaps the
    ``_latest`` reference — two single-reference assignments, each atomic
    under the interpreter. Readers of ``latest()`` pay one attribute load.

**Device ordering.** A JAX array is a future that blocks its reader; a
torch tensor is not. The snapshot behind a publish may still be computing
on the publisher's CUDA stream when it is ringed (the ingest thread never
waits for its reduction), and a reader thread enqueues its own work on its
own current stream. This module makes the ordering explicit, by **an event
that each reader's stream waits on** (not by running readers on the
publisher's stream, which would queue every read behind ingestion and
every ingest sync behind the reads): :func:`fence` wraps a snapshot
published on a CUDA stream in a :class:`FencedSnapshot`, which records an
event on that stream at publish time. Before a reader touches a tensor of
the snapshot, its current stream waits on the event, and each of those
tensors is ``record_stream``-ed onto the reader's stream, so the caching
allocator does not hand their memory back to the publisher while the
reader's work is still queued. A lazy snapshot materializes on the
publishing stream, where the state it captured was written, and records a
second event after its reduction that readers wait on instead. On the CPU
nothing is wrapped.

Version-pinned reads (``get(version)``) serve read-your-writes flows
through a version→snapshot index (one dict lookup — O(1) at any depth); a
version that has been evicted raises :class:`StaleSnapshotError` instead
of silently returning a different stream position.

``publish`` is single-writer by contract (the IngestLoop thread, or one
caller's own loop); monotonicity is enforced, not assumed. Lazy snapshots ring
identically — eviction drops the ring's reference, but a reader that
pinned one may still materialize it afterwards: its captured state is
never written again (the engine writes only the buffer in place, and a
lazy publish keeps its own copy of a partly filled buffer).
"""
from __future__ import annotations

import collections
import threading

import torch


class StaleSnapshotError(LookupError):
    """A pinned version has been evicted from (or never entered) the ring."""


class FencedSnapshot:
    """A snapshot published on one CUDA stream, safe to read from any stream.

    Exposes the read surface of a (lazy) QuerySnapshot; every tensor access
    first orders the caller's current stream after the snapshot's event
    (module docstring). The cheap fields (``version``, ``kernel``, ``k``,
    ``n_hint``, and ``count_floor`` while a lazy snapshot has a hint) touch
    no tensor.
    """

    def __init__(self, snap, stream: torch.cuda.Stream):
        self._snap = snap
        self._stream = stream
        self._lock = threading.Lock()
        self._seen: set[int] = set()      # reader streams the tensors were recorded onto
        self.version = snap.version
        self.kernel = snap.kernel
        self.k = snap.k
        self.n_hint = getattr(snap, "n_hint", None)
        published = torch.cuda.Event()
        published.record(stream)
        # (materialized snapshot, the event its tensors are ready at)
        self._ready = (snap, published) if getattr(snap, "materialized", True) else None

    @property
    def stream(self) -> torch.cuda.Stream:
        """The publishing stream."""
        return self._stream

    @property
    def materialized(self) -> bool:
        return self._ready is not None

    def _resolve(self):
        ready = self._ready
        if ready is None:
            with self._lock:
                if self._ready is None:
                    with torch.cuda.stream(self._stream):
                        snap = self._snap.materialize()
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    self._ready = (snap, done)
                ready = self._ready
        return ready

    def _acquire(self):
        """The materialized snapshot, ordered for the caller's current stream."""
        snap, ready = self._resolve()
        cur = torch.cuda.current_stream(self._stream.device)
        if cur != self._stream:
            cur.wait_event(ready)
            if cur.cuda_stream not in self._seen:
                for t in (*snap.summary, snap.n, snap.shard_n):
                    t.record_stream(cur)
                self._seen.add(cur.cuda_stream)
        return snap

    def materialize(self) -> "FencedSnapshot":
        self._acquire()
        return self

    @property
    def summary(self):
        return self._acquire().summary

    @property
    def n(self) -> torch.Tensor:
        return self._acquire().n

    @property
    def shard_n(self) -> torch.Tensor:
        return self._acquire().shard_n

    @property
    def tenants(self) -> int:
        return self._acquire().tenants

    @property
    def min_count(self) -> torch.Tensor:
        return self._acquire().min_count

    @property
    def occupancy(self) -> torch.Tensor:
        return self._acquire().occupancy

    @property
    def count_floor(self) -> int:
        if self._ready is None and self.n_hint is not None:
            return self.n_hint // self.k
        return int(self.n) // self.k

    def total(self) -> int:
        return int(self.n)

    def describe(self) -> dict:
        return self._acquire().describe()


def fence(snap, device):
    """``snap`` as readers on any stream may use it: a :class:`FencedSnapshot`
    on the current stream of a CUDA ``device``, ``snap`` itself elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return snap
    return FencedSnapshot(snap, torch.cuda.current_stream(device))


class SnapshotRing:
    """Single-writer / many-reader ring of versioned QuerySnapshots."""

    def __init__(self, depth: int = 4):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        # version → snapshot index + FIFO eviction order: get() is one
        # dict lookup regardless of depth, and non-contiguous versions
        # (a caller's loop skipping numbers) evict oldest-first instead of
        # colliding in a modulo slot
        self._by_version: dict = {}
        self._order: collections.deque = collections.deque()
        self._latest = None
        # waiters only: publish notifies under this lock, but neither
        # publish's slot/latest stores nor latest()/get() ever take it —
        # the read path stays wait-free.
        self._cond = threading.Condition()

    # -- write side (single publisher) --------------------------------------

    def publish(self, snap):
        """Make ``snap`` the latest readable version (atomic swap).

        Versions must be strictly increasing — a republished/older version
        would let a reader time-travel backwards between two ``latest()``
        calls.
        """
        prev = self._latest
        if prev is not None and snap.version <= prev.version:
            raise ValueError(
                f"publish: version {snap.version} is not after the "
                f"latest published version {prev.version} (the ring is "
                f"single-writer with strictly increasing versions)")
        self._by_version[snap.version] = snap
        self._order.append(snap.version)
        self._latest = snap
        while len(self._order) > self.depth:
            self._by_version.pop(self._order.popleft(), None)
        with self._cond:
            self._cond.notify_all()
        return snap

    # -- read side (wait-free) ----------------------------------------------

    def latest(self):
        """The newest complete published snapshot (None before the first)."""
        return self._latest

    @property
    def latest_version(self) -> int:
        """Version of the newest published snapshot (0 before the first)."""
        snap = self._latest
        return 0 if snap is None else snap.version

    def get(self, version: int):
        """The snapshot published as ``version`` — if it is still ringed.

        One atomic dict lookup (O(1) at any depth); a concurrent eviction
        yields :class:`StaleSnapshotError`, never a snapshot from a
        different stream position.
        """
        snap = self._by_version.get(version)
        if snap is None:
            raise StaleSnapshotError(
                f"version {version} is not in the ring (latest "
                f"{self.latest_version}, depth {self.depth}): it was "
                f"evicted or never published")
        return snap

    def wait_for(self, min_version: int, timeout: float | None = None):
        """Block until a snapshot with version >= ``min_version`` exists.

        Raises TimeoutError on expiry.
        """
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self.latest_version >= min_version, timeout)
        if not ok:
            raise TimeoutError(
                f"no snapshot reached version {min_version} within "
                f"{timeout}s (latest {self.latest_version})")
        return self._latest


class RingPublisher:
    """Binds one runtime's ``snapshot()`` to one ring — THE write surface.

    Consumers that drive their own ingestion loop publish through this
    instead of calling ``runtime.snapshot()`` ad hoc, so every published
    view goes through the same versioned ring (and the same stream fence)
    the IngestLoop uses.
    """

    def __init__(self, runtime, ring: SnapshotRing):
        self.runtime = runtime
        self.ring = ring

    def publish(self, state, *, lazy: bool = False, n_hint: int | None = None,
                on_materialize=None):
        """Snapshot ``state`` on the current stream (no wait) and ring it.

        ``lazy=True`` publishes a deferred snapshot (reduction on first
        read); it keeps its own copy of a partly filled buffer.
        """
        snap = self.runtime.snapshot(state, lazy=lazy, n_hint=n_hint,
                                     on_materialize=on_materialize)
        return self.ring.publish(fence(snap, self.runtime.engine.device))
