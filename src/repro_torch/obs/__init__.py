"""Observability — metrics, their time series, and trace spans.

The counterpart of the first three modules of ``repro.obs`` (DESIGN.md
§12, §14), held equal to them by ``tests/test_torch_obs.py``:

  * :mod:`repro_torch.obs.metrics` — thread-safe counters / gauges /
    fixed-bucket histograms, plain dict + Prometheus exports, and a no-op
    NULL registry;
  * :mod:`repro_torch.obs.timeseries` — bounded ring-buffer histories
    behind every instrument, pumped by ``MetricsRegistry.sample()``;
  * :mod:`repro_torch.obs.trace` — nested spans over a bounded event
    ring, with optional ``torch.profiler.record_function`` pass-through.

The sketch-native health gauges, drift sentinel, alerts and flight
recorder of ``repro.obs`` are not ported yet.
"""
from repro_torch.obs.metrics import (DEFAULT as DEFAULT_REGISTRY, NULL as
                                     NULL_REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     log_bounds, prom_escape_label)
from repro_torch.obs.timeseries import MetricsSampler, TimeSeriesStore
from repro_torch.obs.trace import (DEFAULT as DEFAULT_TRACER, NULL as
                                   NULL_TRACER, Tracer, event, fmt_event, log,
                                   span)

__all__ = [
    "Counter", "DEFAULT_REGISTRY", "DEFAULT_TRACER", "Gauge", "Histogram",
    "MetricsRegistry", "MetricsSampler", "NULL_REGISTRY", "NULL_TRACER",
    "TimeSeriesStore", "Tracer", "default_registry", "event", "fmt_event",
    "log", "log_bounds", "prom_escape_label", "span",
]
