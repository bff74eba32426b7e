"""ServeFrontend — the serving tier's one consumer-facing read surface.

The counterpart of ``repro.serve.frontend``.

Answers point / top-n / k-majority queries from the newest complete
:class:`~repro_torch.service.snapshot.QuerySnapshot` in a
:class:`~repro_torch.serve.ring.SnapshotRing`, planned and batched through the
existing :class:`~repro_torch.service.QueryFrontend` (same dispatched kernels,
same bucketing) — the serving tier adds *which version answers* and
*where the device wait is paid*, nothing about how a query runs.

Every answer is **host-materialized before it is returned** and carries
the ``version``/``n`` provenance of the snapshot that answered it. The
materialization is the deliberate SLO hook: the reader's stream waits on
the snapshot's publish event (``serve.ring.FencedSnapshot``) and the copy
to the host waits for the reader's stream, so an answer built from a
just-published snapshot blocks *here*, on the reader, until the ring's
async reduction lands — query latency as measured by ``bench_serve``
therefore includes the real freshness cost, and the ingest loop never
pays it (the QPOPSS split).

The sync methods are thread-safe (snapshots are immutable; the
QueryFrontend is stateless) — bench reader threads call them directly.
The ``a``-prefixed coroutines wrap them in a worker thread
(``asyncio.to_thread``) so an asyncio server can issue queries without
blocking its event loop on device waits.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.ring import SnapshotRing
from repro_torch.service.frontend import FrequentItemsReport, QueryFrontend
from repro_torch.service.snapshot import QuerySnapshot

# the obs layer's per-op read surface: one latency histogram per op name
# (shared with launch/bench_serve.py — the bench reports p50/p99 from
# these, not from a private sample list)
READ_OPS = ("point", "top", "kmaj")


@dataclasses.dataclass(frozen=True)
class PointEstimates:
    """Batched point answers + the provenance of the snapshot that
    produced them (lower ≤ f ≤ f_hat elementwise, per the paper)."""

    version: int
    n: int
    f_hat: np.ndarray
    lower: np.ndarray
    monitored: np.ndarray


@dataclasses.dataclass(frozen=True)
class TopTable:
    """Host-side top-n rows ({item, count, lower}) + provenance."""

    version: int
    n: int
    rows: list


class ServeFrontend:
    """Ring-backed query surface: latest-complete reads, zero writer cost."""

    def __init__(self, ring: SnapshotRing, frontend: QueryFrontend, *,
                 registry=None):
        self.ring = ring
        self.frontend = frontend
        self.registry = (obs_metrics.DEFAULT if registry is None
                         else registry)
        self._m_read = {op: self.registry.histogram(f"serve.read.{op}_s")
                        for op in READ_OPS}
        self._m_staleness = self.registry.gauge(
            "serve.read.staleness_versions")
        self._m_floor = self.registry.counter("serve.read.floor_answers")

    def _observe(self, op: str, version: int, t0: float) -> None:
        """Record one answered read: wall latency (ring lookup + batched
        dispatch + host materialization) and how many versions the
        answering snapshot trails the ring's newest at answer time."""
        self._m_read[op].record(time.perf_counter() - t0)
        self._m_staleness.set(self.ring.latest_version - version)

    # -- snapshot selection --------------------------------------------------

    def snapshot(self, *, min_version: int = 0,
                 timeout: float | None = None) -> QuerySnapshot:
        """The newest published snapshot (wait-free once one exists).

        ``min_version`` turns the read into read-your-writes: block until
        the ring has at least that version (``timeout`` bounds the wait).
        Before any publish, waits for version 1 rather than failing.
        """
        snap = self.ring.latest()
        if snap is not None and snap.version >= min_version:
            return snap
        return self.ring.wait_for(max(min_version, 1), timeout)

    # -- queries (sync, thread-safe) -----------------------------------------

    def estimate(self, queries, *, resolution: int | None = None,
                 min_version: int = 0,
                 timeout: float | None = None) -> PointEstimates:
        """(f̂, lower, monitored) per query id from the latest snapshot.

        ``resolution`` opts into the QPOPSS min-count filter (DESIGN.md
        §13): the caller declares it only needs counts distinguished at
        that granularity. When ``resolution <= count_floor`` — the
        publish-time ⌊n/k⌋ scalar, an upper bound on the sketch's own ε
        error — the summary cannot resolve anything finer, so the answer
        is the conservative unmonitored interval (f̂ = count_floor,
        lower = 0, monitored = False) WITHOUT touching the summary: on a
        lazy snapshot this path never forces the deferred reduction.
        For an unmonitored id this is the exact answer with min_count
        loosened to its a-priori bound; a caller that needs monitored
        heavy hitters resolved must not pass ``resolution`` (or pass one
        above the floor).
        """
        t0 = time.perf_counter()
        snap = self.snapshot(min_version=min_version, timeout=timeout)
        if resolution is not None and resolution <= snap.count_floor:
            q = np.atleast_1d(np.asarray(queries))
            floor = int(snap.count_floor)
            n_hint = getattr(snap, "n_hint", None)
            n = (n_hint
                 if not getattr(snap, "materialized", True)
                 and n_hint is not None else int(snap.n))
            out = PointEstimates(
                version=snap.version, n=int(n),
                f_hat=np.full(q.shape, floor, dtype=np.int64),
                lower=np.zeros(q.shape, dtype=np.int64),
                monitored=np.zeros(q.shape, dtype=bool))
            self._m_floor.inc()
            self._observe("point", snap.version, t0)
            return out
        f_hat, lower, mon = self.frontend.estimate(snap, queries)
        out = PointEstimates(version=snap.version, n=int(snap.n),
                             f_hat=f_hat.cpu().numpy(),
                             lower=lower.cpu().numpy(),
                             monitored=mon.cpu().numpy())
        self._observe("point", snap.version, t0)
        return out

    def top_table(self, n: int = 10, *, min_version: int = 0,
                  timeout: float | None = None) -> TopTable:
        """Host-side top-n rows from the latest snapshot."""
        t0 = time.perf_counter()
        snap = self.snapshot(min_version=min_version, timeout=timeout)
        out = TopTable(version=snap.version, n=int(snap.n),
                       rows=self.frontend.top_table(snap, n))
        self._observe("top", snap.version, t0)
        return out

    def k_majority_report(self, k_majority: int, *, min_version: int = 0,
                          timeout: float | None = None
                          ) -> FrequentItemsReport:
        """The paper's guarantee-split report from the latest snapshot
        (already host-side and version-stamped by the QueryFrontend)."""
        t0 = time.perf_counter()
        snap = self.snapshot(min_version=min_version, timeout=timeout)
        out = self.frontend.k_majority_report(snap, k_majority)
        self._observe("kmaj", snap.version, t0)
        return out

    # -- queries (async) -----------------------------------------------------

    async def aestimate(self, queries, *, resolution: int | None = None,
                        min_version: int = 0,
                        timeout: float | None = None) -> PointEstimates:
        return await asyncio.to_thread(
            self.estimate, queries, resolution=resolution,
            min_version=min_version, timeout=timeout)

    async def atop_table(self, n: int = 10, *, min_version: int = 0,
                         timeout: float | None = None) -> TopTable:
        return await asyncio.to_thread(
            self.top_table, n, min_version=min_version, timeout=timeout)

    async def ak_majority_report(self, k_majority: int, *,
                                 min_version: int = 0,
                                 timeout: float | None = None
                                 ) -> FrequentItemsReport:
        return await asyncio.to_thread(
            self.k_majority_report, k_majority, min_version=min_version,
            timeout=timeout)
