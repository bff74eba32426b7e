"""IngestLoop — continuous StreamRuntime ingestion off a bounded queue.

The counterpart of ``repro.serve.ingest``: the write half of the serving
tier (DESIGN.md §11). One daemon thread owns the runtime's
:class:`SketchState` exclusively and drains a bounded admission queue of
host stream blocks. Each block takes the path ``StreamRuntime.feed``
takes — host-side canonical decomposition (``host_blocks``), staged
host→device copy, ``runtime.engine.ingest`` of this rank's rows — so a
served sketch is bitwise-identical to a batch-fed one over the same
blocks (tested in tests/test_torch_serve.py for every CPU impl, and on
the card by ``chip_smoke.py``).

Throughput discipline, in order of importance (DESIGN.md §11, §13):

  * **ingestion never waits for readers.** On a CUDA device the loop runs
    on a stream of its own (``IngestLoop.stream``): publishing records an
    event there and swaps the ring pointer at once — or, with
    ``lazy_publish``, dispatches no reduction until a reader asks —
    and readers order their own streams after that event
    (``serve.ring.FencedSnapshot``). The engine's blocking host syncs
    (``absorb_pool``'s m₂ copy under ``cuda``/``sorted``) wait for the
    loop's stream only, never for reader work.
  * **wakeups drain, dispatches coalesce.** Each wakeup drains every
    consecutively queued block (up to a control item), groups them into
    at most ``coalesce_max``-block batches, and ingests each batch as
    ONE engine call over the concatenated canonical decomposition —
    bitwise-identical to per-block ingestion (the engine scans chunks in
    order; ``coalesce_blocks``). Groups never straddle a publish
    boundary, so the publish cadence (positions AND count) is exactly
    the per-block loop's.
  * **transfers run ahead of compute.** Batches are staged through a
    :class:`~repro_torch.runtime.feed.DeviceStager` ``feed_depth`` deep
    (pinned buffers and a copy stream on a CUDA device): the copy of
    batch i+1 is issued before the ingest of batch i is dispatched.
  * **buffer ownership instead of a donation fence.** JAX alternates a
    donating and a non-donating ingest program so that a published
    snapshot's buffers are never aliased. The port's engine writes
    ``state.buffer`` in place and replaces every other field, so: the
    loop's first ingest writes into a clone of the caller's buffer (the
    caller's state stays valid, as with ``StreamRuntime.feed``); an eager
    publish is dispatched on the loop's stream before any later ingest
    writes the buffer; and a lazy publish keeps its own copy of a partly
    filled buffer (``StreamRuntime.snapshot``), so a lazy snapshot is
    valid *forever*: a reader may materialize it long after the ring
    evicted it.

Admission control is the queue bound: ``submit`` blocks (backpressure) or
sheds (counted, reported in :class:`IngestStats`) per the configured
policy. ``drain()`` waits until everything submitted so far is ingested
and publishes a final snapshot at exactly that stream position — the
hook the bench harness's bitwise gate is built on. (Queue order is
preserved under coalescing: a drain stops at the first control item, so
a ``publish_now`` resolves after every block submitted before it and
before any block submitted after.)
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.engine.state import SketchState
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.feed import DeviceStager, coalesce_blocks
from repro_torch.serve.ring import RingPublisher, SnapshotRing
from repro_torch.service.snapshot import QuerySnapshot

_BLOCK, _PUBLISH, _STOP = "block", "publish", "stop"


class IngestStats:
    """Host-side counters of one IngestLoop (read-only for consumers).

    Written from two threads — producers bump ``blocks_submitted`` /
    ``blocks_shed`` inside ``submit()`` while the loop thread bumps
    ``blocks_ingested`` / ``items_ingested`` / ``publishes`` — so every
    mutation and every read goes through one lock: ``describe()`` is a
    *consistent* snapshot (a reader can never observe
    ``blocks_ingested``/``items_ingested`` torn relative to each other or
    mid-update), and fields that must move together are updated in one
    ``add()`` call. The earlier dataclass mutated public fields in place,
    which let an unsynchronized reader see exactly those torn states.
    """

    FIELDS = ("blocks_submitted",   # accepted into the queue
              "blocks_shed",        # rejected by 'shed' admission
              "blocks_ingested",    # actually fed into the sketch
              "items_ingested",     # stream items across ingested blocks
              "publishes")          # snapshots published to the ring

    __slots__ = ("_lock",) + tuple("_" + f for f in FIELDS)

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, "_" + f, 0)

    def add(self, **deltas) -> None:
        """Atomically apply one batch of counter deltas."""
        with self._lock:
            for name, d in deltas.items():
                if name not in self.FIELDS:
                    raise AttributeError(f"IngestStats has no counter "
                                         f"{name!r}")
                setattr(self, "_" + name, getattr(self, "_" + name) + d)

    def describe(self) -> dict:
        """One lock-consistent snapshot of every counter."""
        with self._lock:
            return {f: getattr(self, "_" + f) for f in self.FIELDS}

    # per-field reads share the same lock, so a single field is never
    # observed mid-update either
    @property
    def blocks_submitted(self) -> int:
        with self._lock:
            return self._blocks_submitted

    @property
    def blocks_shed(self) -> int:
        with self._lock:
            return self._blocks_shed

    @property
    def blocks_ingested(self) -> int:
        with self._lock:
            return self._blocks_ingested

    @property
    def items_ingested(self) -> int:
        with self._lock:
            return self._items_ingested

    @property
    def publishes(self) -> int:
        with self._lock:
            return self._publishes


class _Pending:
    """A publish request: resolves to the snapshot (or the loop error)."""

    def __init__(self):
        self._event = threading.Event()
        self.snapshot: QuerySnapshot | None = None

    def resolve(self, snap):
        self.snapshot = snap
        self._event.set()

    def wait(self, timeout=None) -> QuerySnapshot | None:
        if not self._event.wait(timeout):
            raise TimeoutError("publish request not served in time")
        return self.snapshot


class IngestLoop:
    """Single consumer thread: queue → decompose → ingest → publish."""

    def __init__(self, runtime, ring: SnapshotRing, *,
                 publish_every: int, queue_depth: int = 8,
                 admission: str = "block", coalesce_max: int = 1,
                 feed_depth: int = 2, lazy_publish: bool = False,
                 state=None, registry=None, tracer=None, on_error=None):
        if publish_every < 1:
            raise ValueError(
                f"publish_every must be >= 1, got {publish_every}")
        if admission not in ("block", "shed"):
            raise ValueError(f"admission {admission!r} not in "
                             f"('block', 'shed')")
        if coalesce_max < 1:
            raise ValueError(
                f"coalesce_max must be >= 1, got {coalesce_max}")
        if feed_depth < 1:
            raise ValueError(f"feed_depth must be >= 1, got {feed_depth}")
        self.runtime = runtime
        self.ring = ring
        self.publish_every = publish_every
        self.admission = admission
        self.coalesce_max = coalesce_max
        self.feed_depth = feed_depth
        self.lazy_publish = lazy_publish
        self.stats = IngestStats()
        # instruments are created once here; record() on the loop path is
        # then O(1) with no name lookups (DESIGN.md §12 overhead budget)
        self.registry = (obs_metrics.DEFAULT if registry is None
                         else registry)
        self.tracer = obs_trace.DEFAULT if tracer is None else tracer
        reg = self.registry
        self._m_queue_depth = reg.gauge("serve.ingest.queue_depth")
        self._m_step = reg.histogram("serve.ingest.step_s")
        self._m_publish = reg.histogram("serve.ingest.publish_s")
        self._m_blocks = reg.counter("serve.ingest.blocks")
        self._m_items = reg.counter("serve.ingest.items")
        self._m_shed = reg.counter("serve.ingest.shed")
        # pipeline observability (DESIGN.md §13): actual coalesce batch
        # sizes, and how many lazy publishes a reader ever forced
        self._m_coalesce = reg.histogram("serve.ingest.coalesce_blocks")
        self._m_deferred = reg.counter("serve.publish.deferred")
        self._m_materialized = reg.counter("serve.publish.materialized")
        # invoked (once, from the loop thread) with the captured
        # exception — the flight recorder's ingest-error dump trigger
        self.on_error = on_error
        self._publisher = RingPublisher(runtime, ring)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._state = state if state is not None else runtime.init()
        self._error: BaseException | None = None
        self._closed = False        # no further submissions accepted
        # the loop's own CUDA stream (None on the CPU): every ingest and
        # publish of the loop is enqueued there (module docstring)
        device = runtime.engine.device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._thread = threading.Thread(
            target=self._run, name="repro-serve-ingest", daemon=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "IngestLoop":
        if self.stream is not None:
            # the initial state may still be computing on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        self._thread.start()
        return self

    def __enter__(self) -> "IngestLoop":
        return self.start()

    def __exit__(self, exc_type, *_):
        self.stop(drain=exc_type is None)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def _check_error(self):
        if self._error is not None:
            raise RuntimeError(
                "IngestLoop failed; no further blocks will be ingested"
            ) from self._error

    # -- producer side -------------------------------------------------------

    def submit(self, block, *, timeout: float | None = None) -> bool:
        """Enqueue one (N,) host stream block; returns False iff shed.

        ``'block'`` admission waits for queue space (raises ``queue.Full``
        only if ``timeout`` expires — bounded backpressure); ``'shed'``
        drops immediately on a full queue and counts the loss.
        """
        self._check_error()
        if self._closed:
            raise RuntimeError("IngestLoop is stopped; cannot submit")
        if self.admission == "shed":
            try:
                self._queue.put_nowait((_BLOCK, block))
            except queue.Full:
                self.stats.add(blocks_shed=1)
                self._m_shed.inc()
                return False
        else:
            self._queue.put((_BLOCK, block), timeout=timeout)
        self.stats.add(blocks_submitted=1)
        self._m_queue_depth.set(self._queue.qsize())
        return True

    def publish_now(self, timeout: float | None = None) -> QuerySnapshot:
        """Queue-ordered snapshot publish: after everything submitted so
        far, before anything submitted later. Blocks until served."""
        self._check_error()
        req = _Pending()
        self._queue.put((_PUBLISH, req))
        remaining = timeout
        while True:                 # poll so a dead loop thread can't
            try:                    # strand the waiter forever
                snap = req.wait(0.1 if remaining is None
                                else min(0.1, remaining))
                break
            except TimeoutError:
                self._check_error()
                if not self.running:
                    raise RuntimeError(
                        "IngestLoop thread exited before serving the "
                        "publish request") from None
                if remaining is not None:
                    remaining -= 0.1
                    if remaining <= 0:
                        raise
        self._check_error()
        return snap

    def drain(self, timeout: float | None = None) -> QuerySnapshot:
        """Ingest everything already queued, then publish that position."""
        return self.publish_now(timeout)

    def sync(self) -> None:
        """Block until the device work behind every dispatched ingest has
        completed — a *measurement* barrier, not a serving primitive.

        ``drain()`` resolves when the loop has dispatched everything
        queued; the dispatches themselves stay asynchronous, and with
        coalescing + lazy publishes a whole stream can fit the backend's
        in-flight window — a timer stopped at ``drain()`` would then
        measure enqueue, not compute. The bench harness calls this inside
        its timed region so updates/sec means sustained ingest. Readers
        never need it: they block on materializing their own answers.
        """
        if self.stream is not None:
            self.stream.synchronize()

    def stop(self, *, drain: bool = True,
             timeout: float | None = None) -> QuerySnapshot | None:
        """Stop the loop; with ``drain`` (default) finish queued work and
        publish the final position first. Idempotent."""
        snap = None
        if self._closed:
            self._thread.join(timeout)
            return None
        if drain and self.running and self._error is None:
            snap = self.drain(timeout)
        self._closed = True
        if self.running:
            self._queue.put((_STOP, None))
        self._thread.join(timeout)
        self._check_error()
        return snap

    # -- consumer side (the loop thread) ------------------------------------

    def _run(self):
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else contextlib.nullcontext())
        with ctx:
            self._loop()

    def _loop(self):
        rt = self.runtime
        chunk = rt.config.engine.chunk
        workers = rt.workers
        rows = rt.rows
        engine = rt.engine
        stager = DeviceStager(device=engine.device, depth=self.feed_depth)
        since_publish = 0
        try:
            # version 0-of-this-loop: readers attached before the first
            # block always find a complete (possibly empty) snapshot
            self._publish()
            # the engine writes the buffer in place: the first ingest
            # writes into a copy, so the caller's state stays valid
            s = self._state
            self._state = SketchState(s.summary, s.buffer.clone(), s.fill, s.n)
            while True:
                item = self._queue.get()
                if item[0] != _BLOCK:
                    kind, payload = item
                    if kind == _STOP:
                        break
                    since_publish = 0
                    payload.resolve(self._publish())
                    continue

                # drain every consecutively queued block; a control item
                # ends the drain (blocks batched here all PRECEDE it in
                # queue order, so ingest-then-resolve keeps publish_now's
                # "after everything submitted so far" contract)
                payloads = [item[1]]
                ctl = None
                while ctl is None:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt[0] == _BLOCK:
                        payloads.append(nxt[1])
                    else:
                        ctl = nxt

                # pre-plan coalesce groups: capped at coalesce_max AND at
                # the distance to the next publish boundary, so publish
                # positions and counts are identical to the per-block loop
                groups, i, sp = [], 0, since_publish
                while i < len(payloads):
                    cap = max(1, min(self.coalesce_max,
                                     self.publish_every - sp))
                    g = payloads[i:i + cap]
                    groups.append(g)
                    i += len(g)
                    sp += len(g)
                    if sp >= self.publish_every:
                        sp = 0

                # stage ahead (async copies), then dispatch each group's
                # single coalesced ingest; take() → top_up() → dispatch
                # keeps feed_depth copies in flight while the previous
                # group's compute runs
                gi = 0

                def top_up():
                    nonlocal gi
                    while gi < len(groups) and stager.room:
                        g = groups[gi]
                        arrays = [np.asarray(p) for p in g]
                        block = coalesce_blocks(arrays, workers, chunk)
                        items = sum(int(a.size) for a in arrays)
                        stager.stage(block[rows], (len(g), items))
                        gi += 1

                top_up()
                while len(stager):
                    t0 = time.perf_counter()
                    with self.tracer.span("ingest.step"):
                        dev, (nb, items) = stager.take()
                        top_up()
                        if dev.shape[-1]:
                            self._state = engine.ingest(self._state, dev)
                            self.stats.add(blocks_ingested=nb,
                                           items_ingested=items)
                            self._m_items.inc(items)
                        else:
                            self.stats.add(blocks_ingested=nb)
                    self._m_blocks.inc(nb)
                    self._m_coalesce.record(nb)
                    self._m_step.record(time.perf_counter() - t0)
                    self._m_queue_depth.set(self._queue.qsize())
                    since_publish += nb
                    if since_publish >= self.publish_every:
                        since_publish = 0
                        self._publish()

                if ctl is not None:
                    kind, payload = ctl
                    if kind == _STOP:
                        break
                    since_publish = 0
                    payload.resolve(self._publish())
        except BaseException as e:           # pragma: no cover - rethreaded
            self._error = e
            # unblock any publish waiters; they re-raise via _check_error
            try:
                while True:
                    kind, payload = self._queue.get_nowait()
                    if kind == _PUBLISH:
                        payload.resolve(None)
            except queue.Empty:
                pass
            self.tracer.event("ingest.error", type=type(e).__name__,
                              message=str(e))
            if self.on_error is not None:
                try:
                    self.on_error(e)        # flight-recorder dump
                except Exception:           # a broken recorder must not
                    pass                    # mask the original error

    def _publish(self) -> QuerySnapshot:
        # timed around the (async or deferred) dispatch + ring swap: this
        # is the write path's entire snapshot cost (readers pay
        # materialization). Lazy publishes capture the state reference +
        # the writer's own item count (the count_floor ε filter) and ring
        # immediately; the materialized counter tells the bench how many
        # versions a reader ever actually forced.
        t0 = time.perf_counter()
        lazy = self.lazy_publish
        with self.tracer.span("ingest.publish"):
            snap = self._publisher.publish(
                self._state, lazy=lazy,
                n_hint=self.stats.items_ingested if lazy else None,
                on_materialize=self._m_materialized.inc if lazy else None)
        if lazy:
            self._m_deferred.inc()
        self._m_publish.record(time.perf_counter() - t0)
        self.stats.add(publishes=1)
        return snap
