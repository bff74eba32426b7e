"""Metrics — thread-safe counters, gauges, and fixed-bucket histograms.

The counterpart of ``repro.obs.metrics``, a copy: the same instruments, the
same ``describe()`` dicts and the same Prometheus text (DESIGN.md §12).
Every hot-path component records into pre-created instruments owned by a
:class:`MetricsRegistry`, and consumers export the whole registry as a
plain dict (``describe()``) or Prometheus text format (``prometheus()`` —
scrape endpoints). The port's engine, PlanService and StreamRuntime record
into :data:`DEFAULT` under the JAX package's names.

Design constraints, in order:

  * **O(1), allocation-free ``record()``.** A histogram keeps one
    preallocated bucket-count list over *fixed* log-spaced bounds — no
    per-sample list append, no unbounded memory, no sort at read time.
    Percentiles are answered from the bucket counts with a known,
    recorded relative error bound (the bucket-edge growth factor), which
    is what lets a live tier and a bench harness share one code path.
  * **writes are exact under concurrency.** Counters and histograms take
    one uncontended lock per record — ``+=`` on a Python int is NOT
    atomic across bytecodes, and a lost increment in an accounting
    counter is a silent audit failure. Gauges are single-reference swaps and need no lock.
  * **disabling costs one branch.** A registry built with
    ``enabled=False`` (the module's :data:`NULL`) hands out shared no-op
    instruments, so instrumented code never checks a flag.

Instrument names are dotted (``serve.ingest.step_s``); ``prometheus()``
sanitizes them to the ``[a-zA-Z_:][a-zA-Z0-9_:]*`` charset.
"""
from __future__ import annotations

import bisect
import math
import threading
import time

# Default latency buckets: 8 per decade over [1µs, 100s]. The growth
# factor 10^(1/8) ≈ 1.334 bounds the relative error of any bucketized
# percentile at ~33% — recorded per histogram so BENCH consumers can see
# exactly how coarse a reported p99 is.
DEFAULT_PER_DECADE = 8


def log_bounds(lo: float = 1e-6, hi: float = 100.0,
               per_decade: int = DEFAULT_PER_DECADE) -> tuple:
    """Log-spaced histogram bucket upper edges from ``lo`` to ``hi``."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = max(1, round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


class Counter:
    """Monotonic count; ``inc()`` is exact under concurrent writers."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def describe(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-set value. ``set()`` is one reference swap — no lock needed:
    a reader sees the previous value or the new one, never a hybrid."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value) -> None:
        self._value = value

    @property
    def value(self):
        return self._value

    def describe(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket latency/size histogram with conservative percentiles.

    ``record()`` is O(log buckets) (one bisect) + O(1) updates into
    preallocated slots. ``percentile(q)`` returns the upper edge of the
    bucket holding the q-th sample, clamped to the observed max — an
    over-estimate by at most the bucket growth factor
    (``error_bound``), never an under-estimate, so SLO gates built on it
    are conservative.
    """

    __slots__ = ("name", "_bounds", "_counts", "_count", "_sum", "_min",
                 "_max", "_lock", "error_bound")

    def __init__(self, name: str, bounds: tuple | None = None):
        self.name = name
        self._bounds = tuple(bounds) if bounds is not None else log_bounds()
        if list(self._bounds) != sorted(set(self._bounds)):
            raise ValueError(
                f"histogram bounds must be strictly increasing: {bounds}")
        self._counts = [0] * (len(self._bounds) + 1)   # +1 overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()
        self.error_bound = max(
            hi / lo - 1.0
            for lo, hi in zip(self._bounds, self._bounds[1:])) if (
                len(self._bounds) > 1) else 0.0

    def record(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def time(self):
        """Context manager recording the wrapped block's wall seconds."""
        return _Timer(self)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def bounds(self) -> tuple:
        """The fixed bucket upper edges (shared with HistogramSeries)."""
        return self._bounds

    def raw(self) -> tuple:
        """(count, sum, per-bucket counts) in one lock acquisition — the
        time-series sampler's read surface (one consistent frame)."""
        with self._lock:
            return self._count, self._sum, tuple(self._counts)

    def percentile(self, q: float) -> float:
        """Conservative q-th percentile from the bucket counts (nan if
        empty): the bucket's upper edge, clamped to the observed max."""
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            rank = max(1, math.ceil(q / 100.0 * total))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    edge = (self._bounds[i] if i < len(self._bounds)
                            else self._max)
                    return float(min(edge, self._max))
            return float(self._max)        # pragma: no cover - unreachable

    def describe(self) -> dict:
        with self._lock:
            count, s = self._count, self._sum
            mn = self._min if count else float("nan")
            mx = self._max if count else float("nan")
        return {
            "type": "histogram",
            "count": count,
            "sum": s,
            "mean": (s / count) if count else float("nan"),
            "min": mn,
            "max": mx,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "error_bound": self.error_bound,
        }

    def buckets(self) -> list:
        """(upper_edge, cumulative_count) rows — the Prometheus view."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for edge, c in zip(self._bounds, counts):
            cum += c
            out.append((edge, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.record(time.perf_counter() - self._t0)
        return False


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class _NullCounter:
    """Shared no-op counter for disabled registries (one branch to skip
    instrumentation: instrumented code never checks an enabled flag)."""

    __slots__ = ()
    name = "<null>"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def describe(self) -> dict:
        return {"type": "counter", "value": 0}


class _NullGauge:
    __slots__ = ()
    name = "<null>"
    value = 0.0

    def set(self, value) -> None:
        pass

    def describe(self) -> dict:
        return {"type": "gauge", "value": 0.0}


class _NullHistogram:
    __slots__ = ()
    name = "<null>"
    count = 0
    error_bound = 0.0
    bounds = ()

    def record(self, value: float) -> None:
        pass

    def time(self):
        return _NULL_TIMER

    def percentile(self, q: float) -> float:
        return float("nan")

    def describe(self) -> dict:
        return {"type": "histogram", "count": 0}

    def buckets(self) -> list:
        return []

    def raw(self) -> tuple:
        return 0, 0.0, ()


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


def _prom_name(name: str) -> str:
    """Sanitize a dotted instrument name to the Prometheus charset."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    return out if (out and not out[0].isdigit()) else "_" + out


def prom_escape_label(value) -> str:
    """Escape one label VALUE per the Prometheus text exposition format:
    backslash, double-quote, and newline must be backslash-escaped inside
    the quoted value (names are sanitized; values are escaped — an alert
    rule named ``queue "hot"\\n`` must not corrupt the scrape)."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def prom_sample(name: str, labels: dict | None, value) -> str:
    """One exposition line ``name{k="v",...} value`` with escaped label
    values (the conformance-tested label surface of the export)."""
    pname = _prom_name(name)
    if labels:
        body = ",".join(
            f'{_prom_name(str(k))}="{prom_escape_label(v)}"'
            for k, v in labels.items())
        return f"{pname}{{{body}}} {value}"
    return f"{pname} {value}"


class MetricsRegistry:
    """Named get-or-create instrument store; one per scope.

    The process has one :data:`DEFAULT` registry (engine / runtime / plan
    counters); a component that must not aggregate into it (a serving
    tier, a bench phase) owns a private registry. ``enabled=False``
    (:data:`NULL`) hands out shared no-op instruments — the metrics-off
    configuration.
    """

    def __init__(self, enabled: bool = True,
                 series_capacity: int | None = None):
        self.enabled = enabled
        self._instruments: dict = {}
        self._lock = threading.Lock()
        self._series_capacity = series_capacity
        self._timeseries = None

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, *args)
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: tuple | None = None) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        return self._get(name, Histogram, bounds)

    def names(self) -> list:
        with self._lock:
            return sorted(self._instruments)

    def instruments(self) -> list:
        """A consistent (name, instrument) listing, name-sorted."""
        with self._lock:
            return sorted(self._instruments.items())

    # -- time-series pump (DESIGN.md §14) ------------------------------------

    @property
    def timeseries(self):
        """This registry's bounded-history store (NULL when disabled).

        Created lazily on the first access/sample so registries that are
        never pumped (most: the process DEFAULT, test registries) carry
        no history arrays at all.
        """
        if not self.enabled:
            from repro_torch.obs.timeseries import NULL_STORE
            return NULL_STORE
        store = self._timeseries
        if store is None:
            from repro_torch.obs.timeseries import (DEFAULT_CAPACITY,
                                              TimeSeriesStore)
            with self._lock:
                if self._timeseries is None:
                    self._timeseries = TimeSeriesStore(
                        self._series_capacity or DEFAULT_CAPACITY)
                store = self._timeseries
        return store

    def sample(self, t: float | None = None) -> float | None:
        """Append one timestamped sample of every instrument to the
        time-series store (the MetricsSampler pump calls this on its
        fixed interval). Returns the sample time; a disabled registry
        returns None without touching anything — the zero-cost path."""
        if not self.enabled:
            return None
        return self.timeseries.sample_registry(self, t)

    def describe(self) -> dict:
        """Plain {name: instrument.describe()} dict, name-sorted."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.describe() for name, inst in items}

    def prometheus(self) -> str:
        """Prometheus text exposition of every instrument."""
        with self._lock:
            items = sorted(self._instruments.items())
        lines = []
        for name, inst in items:
            pname = _prom_name(name)
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {inst.value}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {inst.value}")
            else:
                d = inst.describe()
                lines.append(f"# TYPE {pname} histogram")
                # exposition-format conformance: _bucket counts are
                # cumulative over increasing le, the +Inf bucket equals
                # _count, and label values go through the escaper
                for edge, cum in inst.buckets():
                    le = "+Inf" if math.isinf(edge) else repr(edge)
                    lines.append(
                        prom_sample(f"{name}_bucket", {"le": le}, cum))
                lines.append(f"{pname}_sum {d['sum']}")
                lines.append(f"{pname}_count {d['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


DEFAULT = MetricsRegistry()
NULL = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    """The process-wide registry (engine/runtime/plan instruments)."""
    return DEFAULT
