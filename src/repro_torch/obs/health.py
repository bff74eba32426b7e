"""Health — sketch-native gauges derived from published QuerySnapshots.

The counterpart of ``repro.obs.health``. Each refresh copies the snapshot's
summary, ``n`` and ``shard_n`` to the host in ONE device→host copy
(:func:`host_copy`; ``HOST_COPIES`` counts them, the drift estimator's
included), and computes every gauge in numpy from that copy.

The paper's accuracy guarantee is a *live* property of the summary: the
minimum counter value m upper-bounds any unmonitored item's true count,
f̂ − ε lower-bounds every monitored one, and both are functions of state
the sketch already holds (the Hurwitz-zeta companion, arXiv:1401.0702,
leans on exactly this). This module turns those invariants into gauges
refreshed from the serving tier's snapshot ring:

  min_count            m — the live ε bound (0 while counters are free)
  occupancy / _frac    live (non-EMPTY) counters in the merged summary
  saturation           n / (k·m): how far past one full rotation of the
                       counter budget the stream is (0 while m = 0); the
                       per-tenant split uses the provenance ``shard_n``
  threshold .. guaranteed_fraction   the k-majority guarantee split —
                       candidates f̂ ≥ ⌊n/k'⌋+1, guaranteed f̂ − ε ≥ it —
                       computed in numpy with the SAME integer arithmetic
                       as ``core.spacesaving.prune``, so the gauges are
                       bitwise-consistent with the eval harness's
                       oracle-free invariants (gated in ``launch/bench_serve.py``'s
                       loaded phase)

Refresh discipline (the QPOPSS split, same as every read in the tier):
materializing a snapshot's arrays blocks on its async reduction, so
:class:`HealthMonitor` does it on its own daemon thread, woken by ring
publishes and coalescing to the newest version when it falls behind — the
ingest loop never waits on a health refresh. Lazy (incremental) publishes
take the split one step further: the monitor's background loop DEFERS on
versions nobody has materialized yet (counted in ``obs.health.deferred``)
instead of forcing their reduction itself — health then reflects the
versions readers actually touched, and an unread stream costs no
background reductions. Explicit ``refresh()`` calls still force the
newest version (the drain/report path needs the true final position).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core.spacesaving import EMPTY

#: device→host copies of snapshots made by :func:`host_copy` (health and
#: drift refreshes), counted as the kernels' launches are
HOST_COPIES = 0
_copies_lock = threading.Lock()


def host_copy(*tensors) -> list[np.ndarray]:
    """numpy copies of ``tensors`` through ONE device→host copy.

    The tensors' bytes are concatenated on their device and copied at
    once, so a refresh pays one synchronising copy, not one per field.
    Counted in ``HOST_COPIES``.
    """
    global HOST_COPIES
    with _copies_lock:
        HOST_COPIES += 1
    flat = [t.detach().reshape(-1).contiguous() for t in tensors]
    raw = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, off = [], 0
    for t, src in zip(flat, tensors):
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(raw[off:off + nbytes].view(dtype).reshape(tuple(src.shape)))
        off += nbytes
    return out


def sketch_health(snap, k_majority: int | None = None) -> dict:
    """Oracle-free health of one QuerySnapshot (host-side plain dict).

    Materializes the snapshot's summary (blocks until its reduction
    lands — call from a reader context, never the ingest thread). All
    integer fields use the same arithmetic as ``repro_torch.core.spacesaving``
    (``min_frequency``, ``prune``), so they agree bitwise with the
    QueryFrontend report the eval harness scores.
    """
    items, counts, errors, n, shard_n = host_copy(*snap.summary, snap.n,
                                                  snap.shard_n)
    n = int(n)
    k = int(items.shape[-1])
    live = items != EMPTY
    occupancy = int(live.sum())
    # m = min counter of a FULL summary, else 0 (mirrors min_frequency:
    # while free counters remain nothing was evicted, the bound is 0)
    min_count = int(counts.min()) if occupancy == k else 0
    denom = k * min_count
    shard_n = np.atleast_1d(shard_n).astype(np.int64)
    tenant_sat = (shard_n / denom).tolist() if denom else (
        [0.0] * shard_n.shape[0])
    out = {
        "version": int(snap.version),
        "n": n,
        "k": k,
        "occupancy": occupancy,
        "occupancy_frac": occupancy / k,
        "min_count": min_count,
        "epsilon_frac": (min_count / n) if n else 0.0,
        "saturation": (n / denom) if denom else 0.0,
        "tenant_saturation": tenant_sat,
    }
    if k_majority is not None:
        k_majority = int(k_majority)
        if k_majority < 1:
            raise ValueError(f"k_majority must be >= 1, got {k_majority}")
        thresh = n // k_majority + 1
        cand = live & (counts >= thresh)
        guaranteed = cand & (counts - errors >= thresh)
        n_cand, n_guar = int(cand.sum()), int(guaranteed.sum())
        out.update({
            "k_majority": k_majority,
            "threshold": thresh,
            "complete": k >= k_majority,
            "candidates": n_cand,
            "guaranteed": n_guar,
            "unconfirmed": n_cand - n_guar,
            "guaranteed_fraction": (n_guar / n_cand) if n_cand else 1.0,
        })
    return out


# gauge-exported scalar fields (list/bool fields stay dict-only)
_GAUGE_FIELDS = ("version", "n", "occupancy", "occupancy_frac",
                 "min_count", "epsilon_frac", "saturation", "threshold",
                 "candidates", "guaranteed", "unconfirmed",
                 "guaranteed_fraction")


class HealthGauges:
    """Binds ``sketch_health`` outputs to gauges in one registry."""

    def __init__(self, registry, *, k_majority: int | None = None,
                 prefix: str = "health"):
        self.registry = registry
        self.k_majority = k_majority
        self.prefix = prefix
        self._latest: dict | None = None
        self.skipped_stale = 0
        self._skipped_gauge = registry.gauge(
            f"{prefix}.refreshes_skipped_stale")
        # one update at a time: interleaved updates of two versions would
        # publish gauges mixed across snapshots
        self._lock = threading.Lock()

    def update(self, snap) -> dict:
        """Refresh every gauge from ``snap`` (skips stale versions)."""
        h = sketch_health(snap, self.k_majority)
        with self._lock:
            if self._latest is not None and (
                    h["version"] < self._latest["version"]):
                # a wedged/racing updater is itself observable
                self.skipped_stale += 1
                self._skipped_gauge.set(self.skipped_stale)
                return self._latest
            for field in _GAUGE_FIELDS:
                if field in h:
                    self.registry.gauge(f"{self.prefix}.{field}").set(
                        h[field])
            self._latest = h
        return h

    def latest(self) -> dict | None:
        """The most recently computed health dict (None before any)."""
        return self._latest


class HealthMonitor:
    """Daemon thread refreshing health gauges on every ring publish.

    Wakes on the ring's publish notification, always reads the *newest*
    version (coalescing — if publishes outpace refreshes, intermediate
    versions are skipped, never queued), and pays the snapshot
    materialization on this thread: the writer-side cost of a health
    refresh is zero, exactly like any other reader of the ring.

    The monitor makes its own wedging observable: the
    ``health.last_refresh_age_s`` gauge is advanced on every poll-loop
    pass — including passes where the ring produced nothing — so a tier
    whose ring stopped publishing shows a growing age instead of a
    silently-frozen health surface (the stock staleness alert rule
    reads exactly this gauge). With a :class:`~repro_torch.obs.drift.
    DriftEstimator` attached, every health refresh also refreshes the
    drift frame from the same snapshot — one materialization feeds
    both.
    """

    def __init__(self, ring, registry, *, k_majority: int | None = None,
                 poll_s: float = 0.1, drift=None):
        self.ring = ring
        self.gauges = HealthGauges(registry, k_majority=k_majority)
        self.drift = drift
        self._poll_s = poll_s
        self._age_gauge = registry.gauge("health.last_refresh_age_s")
        self._last_refresh_t: float | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="repro-obs-health", daemon=True)

    def start(self) -> "HealthMonitor":
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def stop(self, timeout: float | None = 5.0) -> None:
        """Stop the thread; a final refresh captures the drain position."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        if self.ring.latest() is not None:
            self.refresh()

    def refresh(self) -> dict | None:
        """Synchronously refresh from the ring's newest version."""
        snap = self.ring.latest()
        return self._apply(snap) if snap is not None else None

    def latest(self) -> dict | None:
        return self.gauges.latest()

    @property
    def last_refresh_age_s(self) -> float | None:
        """Seconds since the last successful refresh (None before any)."""
        if self._last_refresh_t is None:
            return None
        return time.perf_counter() - self._last_refresh_t

    def _apply(self, snap) -> dict:
        """Gauges + drift frame from one snapshot; stamps the age clock."""
        h = self.gauges.update(snap)
        self._last_refresh_t = time.perf_counter()
        self._age_gauge.set(0.0)
        if self.drift is not None:
            self.drift.update(snap, h, self._last_refresh_t)
        return h

    def _tick_age(self) -> None:
        age = self.last_refresh_age_s
        if age is not None:
            self._age_gauge.set(age)

    def _run(self):
        m_deferred = self.gauges.registry.counter("obs.health.deferred")
        seen = 0
        while not self._stop.is_set():
            try:
                self.ring.wait_for(seen + 1, timeout=self._poll_s)
            except TimeoutError:
                self._tick_age()    # a silent ring still ages the gauge
                continue
            snap = self.ring.latest()       # coalesce to the newest
            if getattr(snap, "materialized", True) is False:
                # lazy publish nobody has read: don't be the reader that
                # forces its reduction — skip, count, and treat the
                # version as seen (a later reader-forced materialization
                # is surfaced by refresh()/stop()'s final refresh)
                m_deferred.inc()
                seen = snap.version
                self._tick_age()
                continue
            try:
                h = self._apply(snap)
            except Exception:               # a torn-down ring at shutdown
                if self._stop.is_set():     # pragma: no cover - race
                    return
                raise
            seen = h["version"]
