"""Time series — bounded ring-buffer histories of metric instruments.

The counterpart of ``repro.obs.timeseries``, a copy (numpy only).
The obs layer's instruments (DESIGN.md §12) are point-in-time: a counter
answers "how many so far", a gauge "what now". A production tier needs
*change over time* — is ingest throughput degrading, is queue depth
climbing, how did p99 move over the last minute — without unbounded
memory or a time-series database. This module adds exactly that layer
(DESIGN.md §14):

  * :class:`SeriesRing` — a preallocated (t, columns) ring: O(1)
    allocation-free append, fixed capacity, oldest samples overwritten
    (wrap-around is the normal steady state, not an edge case);
  * :class:`CounterSeries` / :class:`GaugeSeries` /
    :class:`HistogramSeries` — one ring per instrument with the windowed
    aggregates each kind supports: ``delta``/``rate`` for cumulative
    counts, ``mean``/``min``/``max``/``p50``/``p99`` over sampled gauge
    values, and true *windowed* percentiles for histograms (bucket-count
    deltas between the window's edge samples — the percentile of what
    happened IN the window, not since process start);
  * :class:`TimeSeriesStore` — name → series, pumped from a registry by
    :meth:`MetricsRegistry.sample`: one fixed-interval snapshot of every
    instrument's current value appended to its ring;
  * :class:`MetricsSampler` — the pump daemon: ``registry.sample()`` on
    a fixed interval plus an ``on_sample`` hook where the drift sentinel
    chains alert evaluation and flight-recorder capture (DESIGN.md §14).

Cost discipline: the hot path never touches this module — instruments
record exactly as before; sampling reads each instrument under its own
lock at the pump cadence (default 4 Hz), so the write-path cost of the
whole history layer is the same lock the instrument already takes.
A disabled registry's ``sample()`` returns immediately (the NULL-style
zero-cost path), and a tier with ``metrics=False`` never constructs a
sampler at all.

Every windowed aggregate is recomputable from the raw ring contents
(``Series.rows()``) with plain numpy — a property the test suite
enforces including wrap-around, so the aggregates can never drift from
the data they summarize.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np

DEFAULT_CAPACITY = 512          # samples per series (~2 min at 4 Hz)


class SeriesRing:
    """Fixed-capacity (t, columns) sample ring; O(1) append, no alloc."""

    __slots__ = ("capacity", "width", "_t", "_v", "_next", "_count")

    def __init__(self, capacity: int, width: int = 1):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.capacity = capacity
        self.width = width
        self._t = np.zeros(capacity, dtype=np.float64)
        self._v = np.zeros((capacity, width), dtype=np.float64)
        self._next = 0              # slot the next append writes
        self._count = 0             # live samples (<= capacity)

    def __len__(self) -> int:
        return self._count

    def append(self, t: float, values) -> None:
        i = self._next
        self._t[i] = t
        self._v[i] = values
        self._next = (i + 1) % self.capacity
        if self._count < self.capacity:
            self._count += 1

    def rows(self) -> tuple:
        """(t, values) copies, oldest first — the raw ring contents."""
        n, i = self._count, self._next
        if n < self.capacity:
            return self._t[:n].copy(), self._v[:n].copy()
        order = np.concatenate([np.arange(i, self.capacity),
                                np.arange(0, i)])
        return self._t[order], self._v[order]


def _percentile_from_buckets(bounds, counts, q: float) -> float:
    """Conservative bucketized percentile over per-bucket ``counts`` —
    the same upper-edge rule as ``Histogram.percentile`` (the overflow
    bucket answers the last finite bound; no observed-max clamp exists
    for a *window*, so this is an upper edge, never an under-estimate)."""
    total = int(counts.sum())
    if total <= 0:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * total))
    seen = 0
    for i, c in enumerate(counts):
        seen += int(c)
        if seen >= rank:
            return float(bounds[min(i, len(bounds) - 1)])
    return float(bounds[-1])        # pragma: no cover - unreachable


class Series:
    """One instrument's bounded history + windowed aggregates.

    Subclasses define what one sample row contains and which aggregates
    it supports. All reads slice the ring to the trailing ``window_s``
    seconds (None → the whole ring) and compute with plain numpy —
    bitwise-recomputable from :meth:`rows` by construction.
    """

    kind = "series"

    def __init__(self, name: str, capacity: int = DEFAULT_CAPACITY,
                 width: int = 1):
        self.name = name
        self._ring = SeriesRing(capacity, width)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    def rows(self) -> tuple:
        """(t, values) oldest-first — the raw contents every aggregate
        must be recomputable from (the property test's ground truth)."""
        with self._lock:
            return self._ring.rows()

    def _append(self, t: float, values) -> None:
        with self._lock:
            self._ring.append(t, values)

    def window(self, window_s: float | None = None) -> tuple:
        """Trailing-window slice: samples with t >= newest_t - window_s."""
        t, v = self.rows()
        if window_s is None or t.shape[0] == 0:
            return t, v
        keep = t >= t[-1] - window_s
        return t[keep], v[keep]

    # subclass surface ------------------------------------------------------

    def sample(self, instrument, t: float) -> None:
        raise NotImplementedError

    def aggregates(self, window_s: float | None = None) -> dict:
        raise NotImplementedError

    def aggregate(self, name: str,
                  window_s: float | None = None) -> float:
        """One named windowed aggregate (nan when unsupported/empty)."""
        return self.aggregates(window_s).get(name, float("nan"))


class CounterSeries(Series):
    """History of a cumulative count: ``delta`` and ``rate`` windows."""

    kind = "counter"

    def sample(self, instrument, t: float) -> None:
        self._append(t, float(instrument.value))

    def aggregates(self, window_s: float | None = None) -> dict:
        t, v = self.window(window_s)
        if t.shape[0] == 0:
            return {"last": float("nan"), "delta": float("nan"),
                    "rate": float("nan")}
        vals = v[:, 0]
        delta = float(vals[-1] - vals[0])
        dt = float(t[-1] - t[0])
        return {
            "last": float(vals[-1]),
            "delta": delta,
            "rate": (delta / dt) if dt > 0 else 0.0,
        }


class GaugeSeries(Series):
    """History of an instantaneous value: distribution over the window."""

    kind = "gauge"

    def sample(self, instrument, t: float) -> None:
        self._append(t, float(instrument.value))

    def aggregates(self, window_s: float | None = None) -> dict:
        t, v = self.window(window_s)
        if t.shape[0] == 0:
            return {k: float("nan") for k in
                    ("last", "mean", "min", "max", "p50", "p99")}
        vals = v[:, 0]
        return {
            "last": float(vals[-1]),
            "mean": float(vals.mean()),
            "min": float(vals.min()),
            "max": float(vals.max()),
            "p50": float(np.percentile(vals, 50)),
            "p99": float(np.percentile(vals, 99)),
        }


class HistogramSeries(Series):
    """History of a histogram's (count, sum, per-bucket counts).

    The windowed percentiles are computed from BUCKET-COUNT DELTAS
    between the window's first and last samples — the distribution of
    events that happened inside the window, which a cumulative
    histogram alone cannot answer. Same conservative upper-edge rule
    (and the same recorded ``error_bound``) as the live instrument.
    """

    kind = "histogram"

    def __init__(self, name: str, bounds: tuple,
                 capacity: int = DEFAULT_CAPACITY):
        # columns: count, sum, then one per bucket (incl. overflow)
        self.bounds = tuple(bounds)
        super().__init__(name, capacity, width=2 + len(self.bounds) + 1)

    def sample(self, instrument, t: float) -> None:
        count, total, counts = instrument.raw()
        self._append(t, (float(count), float(total), *map(float, counts)))

    def aggregates(self, window_s: float | None = None) -> dict:
        t, v = self.window(window_s)
        nan = float("nan")
        if t.shape[0] == 0:
            return {k: nan for k in ("last", "delta", "rate", "mean",
                                     "p50", "p99")}
        counts = v[:, 0]
        sums = v[:, 1]
        delta = float(counts[-1] - counts[0])
        dsum = float(sums[-1] - sums[0])
        dt = float(t[-1] - t[0])
        dbuckets = v[-1, 2:] - v[0, 2:]
        return {
            "last": float(counts[-1]),
            "delta": delta,
            "rate": (delta / dt) if dt > 0 else 0.0,
            "mean": (dsum / delta) if delta > 0 else nan,
            "p50": _percentile_from_buckets(self.bounds, dbuckets, 50),
            "p99": _percentile_from_buckets(self.bounds, dbuckets, 99),
        }


class TimeSeriesStore:
    """name → Series, pumped from a MetricsRegistry snapshot at a time."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._series: dict = {}
        self._lock = threading.Lock()
        self._samples = 0

    @property
    def samples(self) -> int:
        """How many pump ticks have landed in this store."""
        return self._samples

    def get(self, name: str) -> Series | None:
        return self._series.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def _series_for(self, name: str, inst):
        s = self._series.get(name)
        if s is not None:
            return s
        # import here to avoid a module cycle (metrics imports nothing
        # from this module; the isinstance dispatch needs its classes)
        from repro_torch.obs.metrics import Counter, Histogram
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if isinstance(inst, Counter):
                    s = CounterSeries(name, self.capacity)
                elif isinstance(inst, Histogram):
                    s = HistogramSeries(name, inst.bounds, self.capacity)
                else:
                    s = GaugeSeries(name, self.capacity)
                self._series[name] = s
        return s

    def sample_registry(self, registry, t: float | None = None) -> float:
        """Append one sample of every instrument; returns the timestamp."""
        if t is None:
            t = time.perf_counter()
        for name, inst in registry.instruments():
            self._series_for(name, inst).sample(inst, t)
        self._samples += 1
        return t

    def value(self, name: str, aggregate: str = "last",
              window_s: float | None = None) -> float | None:
        """One aggregate of one series (None when the series is absent).

        ``aggregate='rate_ratio'`` is the throughput-regression probe:
        rate over the trailing window divided by rate over the whole
        ring — < 1 means the recent window is slower than the run so
        far. Requires ``window_s``.
        """
        s = self.get(name)
        if s is None or len(s) == 0:
            return None
        if aggregate == "rate_ratio":
            recent = s.aggregate("rate", window_s)
            overall = s.aggregate("rate", None)
            if not (math.isfinite(recent) and math.isfinite(overall)):
                return None
            if overall <= 0:
                return None         # nothing flowing: ratio undefined
            return recent / overall
        out = s.aggregate(aggregate, window_s)
        return None if (isinstance(out, float) and math.isnan(out)) else out

    def describe(self, window_s: float | None = None) -> dict:
        """{name: {kind, samples, aggregates}} over the given window."""
        with self._lock:
            items = sorted(self._series.items())
        return {
            name: {"kind": s.kind, "samples": len(s),
                   "capacity": s.capacity,
                   "aggregates": s.aggregates(window_s)}
            for name, s in items
        }


class _NullTimeSeriesStore:
    """Shared no-op store: the disabled registry's zero-cost path."""

    capacity = 0
    samples = 0

    def get(self, name):
        return None

    def names(self):
        return []

    def sample_registry(self, registry, t=None):
        return t if t is not None else 0.0

    def value(self, name, aggregate="last", window_s=None):
        return None

    def describe(self, window_s=None):
        return {}


NULL_STORE = _NullTimeSeriesStore()


class MetricsSampler:
    """Daemon pump: ``registry.sample()`` every ``interval_s`` seconds.

    ``on_sample(t)`` runs after each pump tick on the sampler thread —
    the drift sentinel chains alert evaluation and flight-recorder
    capture there, so the whole sentinel costs the serving hot path
    nothing (DESIGN.md §14). ``tick()`` pumps once synchronously for
    callers that own their own cadence (tests, the --watch CLI's final
    frame)."""

    def __init__(self, registry, *, interval_s: float = 0.25,
                 on_sample=None):
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.interval_s = interval_s
        self.on_sample = on_sample
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="repro-obs-sampler", daemon=True)

    def start(self) -> "MetricsSampler":
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def tick(self, t: float | None = None) -> float:
        """One synchronous pump (sample + on_sample hook)."""
        t = self.registry.sample(t)
        if t is not None and self.on_sample is not None:
            self.on_sample(t)
        return t

    def stop(self, timeout: float | None = 5.0) -> None:
        """Stop the pump; a final tick captures the terminal state."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self.tick()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:       # pragma: no cover - teardown race
                if self._stop.is_set():
                    return
                raise
