"""Serving tier — reads that never block ingestion.

The counterpart of ``repro.serve`` (DESIGN.md §11): continuous
StreamRuntime ingestion behind a bounded admission queue
(:class:`IngestLoop` — backpressure or counted shedding, on a CUDA stream
of its own), immutable versioned snapshots published lock-free into a
:class:`SnapshotRing` (each fenced by an event that readers' streams wait
on), and an async :class:`ServeFrontend` answering point / top-n /
k-majority from the newest complete version through the batching
QueryFrontend. Publish cadence, ring depth, coalescing and lazy publishes
are plan-resolved knobs; ``python -m repro_torch.launch.bench_serve``
measures the tier under mixed read/write load.

Every tier is observable by default (DESIGN.md §12, §14): a tier-scoped
metrics registry and tracer, a :class:`~repro_torch.obs.health.HealthMonitor`
refreshing sketch-native health gauges off the ring, the drift estimator,
alert rules and the flight recorder (``ServingTier.describe()``).
"""
from repro_torch.serve.config import ADMISSION_POLICIES, ServeConfig
from repro_torch.serve.frontend import PointEstimates, ServeFrontend, TopTable
from repro_torch.serve.ingest import IngestLoop, IngestStats
from repro_torch.serve.ring import (FencedSnapshot, RingPublisher, SnapshotRing,
                                    StaleSnapshotError, fence)
from repro_torch.serve.tier import ServingTier

__all__ = [
    "ADMISSION_POLICIES", "FencedSnapshot", "IngestLoop", "IngestStats",
    "PointEstimates", "RingPublisher", "ServeConfig", "ServeFrontend",
    "ServingTier", "SnapshotRing", "StaleSnapshotError", "TopTable", "fence",
]
