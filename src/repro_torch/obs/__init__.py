"""Observability — metrics, trace spans, sketch-native health, drift sentinel.

The counterpart of ``repro.obs`` (DESIGN.md §12, §14), held equal to it by
``tests/test_torch_obs.py`` and ``tests/test_torch_sentinel.py``:

  * :mod:`repro_torch.obs.metrics` — thread-safe counters / gauges /
    fixed-bucket histograms, plain dict + Prometheus exports, and a no-op
    NULL registry;
  * :mod:`repro_torch.obs.timeseries` — bounded ring-buffer histories
    behind every instrument, pumped by ``MetricsRegistry.sample()``;
  * :mod:`repro_torch.obs.trace` — nested spans over a bounded event
    ring, with optional ``torch.profiler.record_function`` pass-through;
  * :mod:`repro_torch.obs.health` — gauges derived from each published
    snapshot (min-count ε bound, occupancy, saturation, the k-majority
    guarantee split), refreshed off the serving ring by a reader thread;
  * :mod:`repro_torch.obs.drift` — online zipf-skew estimation, the
    skew-predicted ε bound, top-n churn, saturation burn;
  * :mod:`repro_torch.obs.alerts` — declarative rules over time-series
    windows with an ok→pending→firing→resolved lifecycle;
  * :mod:`repro_torch.obs.recorder` — a flight recorder dumped as one
    strict-JSON artifact on ingest error, first critical alert, or on
    demand.
"""
from repro_torch.obs.alerts import AlertManager, AlertRule, default_rules
from repro_torch.obs.drift import (DriftEstimator, fit_zipf_skew,
                                   predicted_min_count, top_n_churn)
from repro_torch.obs.health import HealthGauges, HealthMonitor, sketch_health
from repro_torch.obs.metrics import (DEFAULT as DEFAULT_REGISTRY, NULL as
                                     NULL_REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     log_bounds, prom_escape_label)
from repro_torch.obs.recorder import FlightRecorder, validate_flight_record
from repro_torch.obs.timeseries import MetricsSampler, TimeSeriesStore
from repro_torch.obs.trace import (DEFAULT as DEFAULT_TRACER, NULL as
                                   NULL_TRACER, Tracer, event, fmt_event, log,
                                   span)

__all__ = [
    "AlertManager", "AlertRule", "Counter", "DEFAULT_REGISTRY",
    "DEFAULT_TRACER", "DriftEstimator", "FlightRecorder", "Gauge",
    "HealthGauges", "HealthMonitor", "Histogram", "MetricsRegistry",
    "MetricsSampler", "NULL_REGISTRY", "NULL_TRACER", "TimeSeriesStore",
    "Tracer", "default_registry", "default_rules", "event",
    "fit_zipf_skew", "fmt_event", "log", "log_bounds",
    "predicted_min_count", "prom_escape_label", "sketch_health", "span",
    "top_n_churn", "validate_flight_record",
]
