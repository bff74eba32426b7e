"""ServingTier — the assembled concurrent serving stack (DESIGN.md §11).

The counterpart of ``repro.serve.tier``.

One object composes the whole tier from a :class:`ServeConfig`:

    StreamRuntime  ──►  IngestLoop (thread)  ──►  SnapshotRing
         │                   ▲ bounded queue          │ atomic latest
         └─ QueryFrontend ◄──┴── ServeFrontend ◄──────┘
                                       ▲
                     HealthMonitor ────┘ (reader-side gauge refresh)

``submit()`` feeds host stream blocks through the bounded admission
queue; the loop thread ingests them continuously and publishes a
versioned snapshot to the ring every ``publish_every`` blocks (both the
cadence and the ring depth resolve through the active ExecutionPlan when
the config leaves them ``None``). ``frontend`` answers point / top-n /
k-majority reads from the newest complete version with zero ingest-path
interference. Use as a context manager for a drained, clean shutdown:

    with ServingTier(ServeConfig(runtime=RuntimeConfig(...))) as tier:
        for block in stream_blocks:
            tier.submit(block)
        report = tier.frontend.k_majority_report(100)

Observability (DESIGN.md §12): unless ``config.metrics`` is off, the
tier owns a private :class:`~repro_torch.obs.metrics.MetricsRegistry` and
:class:`~repro_torch.obs.trace.Tracer` shared by its loop and frontend — so
concurrent tiers never aggregate into each other — plus a
:class:`~repro_torch.obs.health.HealthMonitor` refreshing sketch-native gauges
(min-count ε bound, occupancy, saturation, guarantee split) off the ring
on every publish, on its own thread. ``describe()`` surfaces config,
consistent ingest stats, the metrics dump, and the latest health;
the JAX package's ``python -m repro.launch.metrics`` renders the same
surface as a CLI.

The drift sentinel (DESIGN.md §14) stacks four more reader-side
threads'-worth of machinery on the same registry, each individually
gated by a config knob and all off when ``metrics`` is off:

  * a :class:`~repro_torch.obs.timeseries.MetricsSampler` pumping bounded
    per-instrument histories at ``sample_interval_s``;
  * a :class:`~repro_torch.obs.drift.DriftEstimator` refreshed by the health
    monitor off every publish (skew fit + CI, predicted-vs-actual ε,
    churn, saturation burn);
  * an :class:`~repro_torch.obs.alerts.AlertManager` evaluated on every
    sampler tick against the time-series windows;
  * a :class:`~repro_torch.obs.recorder.FlightRecorder` capturing a
    postmortem frame per tick and dumping one JSON artifact on ingest
    error, first critical alert, or ``dump_flight_record()``.

Nothing in the sentinel runs on the ingest thread: the sampler and the
health monitor own the only refresh loops, and the ingest loop's sole
new obligation is invoking the recorder's error trigger *after* it has
already captured the failure.
"""
from __future__ import annotations

from repro_torch.obs import alerts as obs_alerts
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import timeseries as obs_timeseries
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import StreamRuntime
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.frontend import ServeFrontend
from repro_torch.serve.ingest import IngestLoop
from repro_torch.serve.ring import SnapshotRing
from repro_torch.service.snapshot import QuerySnapshot


class ServingTier:
    """Runtime + ingest loop + ring + frontend + obs, wired and lifecycled."""

    def __init__(self, config: ServeConfig = ServeConfig(), *,
                 runtime: StreamRuntime | None = None, registry=None,
                 tracer=None):
        # an injected runtime lets several tiers (or a tier and a batch
        # reference path) share one runtime — the bench harness leans on
        # this so every phase runs the same engine
        self.config = config
        self.runtime = (runtime if runtime is not None
                        else StreamRuntime(config.runtime))
        self.publish_every = config.resolved_publish_every()
        self.ring = SnapshotRing(config.resolved_ring_depth())
        # the async-pipeline knobs (DESIGN.md §13) resolve through the
        # active plan exactly like the cadence above
        self.coalesce_max = config.resolved_coalesce_max()
        self.feed_depth = config.runtime.resolved_feed_depth()
        self.lazy_publish = config.resolved_lazy_publish()
        # an injected registry/tracer wins; otherwise each tier scopes its
        # own (or the shared no-op instances when metrics are off)
        if registry is None:
            registry = (obs_metrics.MetricsRegistry(
                series_capacity=config.series_capacity)
                if config.metrics else obs_metrics.NULL)
        if tracer is None:
            tracer = obs_trace.Tracer() if config.metrics else obs_trace.NULL
        self.registry = registry
        self.tracer = tracer

        # -- drift sentinel (DESIGN.md §14), all reader-side ------------
        sentinel = config.metrics
        self.drift = (obs_drift.DriftEstimator(registry)
                      if sentinel and config.drift else None)
        # alerts need sampled histories to window over
        self.alerts = (obs_alerts.AlertManager(
            registry.timeseries, registry,
            rules=config.resolved_alert_rules(), tracer=tracer)
            if sentinel and config.alerts and config.timeseries else None)
        self.recorder = (obs_recorder.FlightRecorder(
            registry, tracer=tracer, alerts=self.alerts,
            health_source=None,     # bound below, after the monitor
            drift_source=self.drift.latest if self.drift else None,
            path=config.flight_path)
            if sentinel and config.flight_recorder else None)
        if self.alerts is not None and self.recorder is not None:
            self.alerts.on_fire = self.recorder.on_alert
        self.sampler = (obs_timeseries.MetricsSampler(
            registry, interval_s=config.sample_interval_s,
            on_sample=self._on_sample)
            if sentinel and config.timeseries else None)

        self.loop = IngestLoop(
            self.runtime, self.ring, publish_every=self.publish_every,
            queue_depth=config.queue_depth, admission=config.admission,
            coalesce_max=self.coalesce_max, feed_depth=self.feed_depth,
            lazy_publish=self.lazy_publish,
            registry=registry, tracer=tracer,
            on_error=(self.recorder.on_error if self.recorder is not None
                      else None))
        self.frontend = ServeFrontend(self.ring, self.runtime.frontend(),
                                      registry=registry)
        self.health = (obs_health.HealthMonitor(
            self.ring, registry, k_majority=config.health_k_majority,
            drift=self.drift)
            if config.metrics else None)
        if self.recorder is not None and self.health is not None:
            self.recorder.health_source = self.health.latest

    def _on_sample(self, t: float) -> None:
        """Sampler-tick chain: rules first, then the postmortem frame
        (so the frame records the transitions this tick caused)."""
        if self.alerts is not None:
            self.alerts.evaluate(t)
        if self.recorder is not None:
            self.recorder.capture(t)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingTier":
        self.loop.start()
        if self.health is not None:
            self.health.start()
        if self.sampler is not None:
            self.sampler.start()
        return self

    def __enter__(self) -> "ServingTier":
        return self.start()

    def __exit__(self, exc_type, *_):
        self.stop(drain=exc_type is None)

    def stop(self, *, drain: bool = True) -> QuerySnapshot | None:
        """Stop ingestion (draining queued blocks first by default)."""
        try:
            snap = self.loop.stop(drain=drain)
        finally:
            # stopped AFTER the loop so the monitor's final refresh
            # reflects the drained stream position, not an intermediate
            # publish; the sampler's final tick then snapshots the final
            # gauges into the histories and the postmortem ring
            if self.health is not None and self.health.running:
                self.health.stop()
            if self.sampler is not None and self.sampler.running:
                self.sampler.stop()
        return snap

    # -- write path ----------------------------------------------------------

    def submit(self, block, *, timeout: float | None = None) -> bool:
        """Admit one (N,) host stream block (False iff shed)."""
        return self.loop.submit(block, timeout=timeout)

    def drain(self, timeout: float | None = None) -> QuerySnapshot:
        """Ingest everything queued and publish exactly that position."""
        return self.loop.drain(timeout)

    # -- telemetry -----------------------------------------------------------

    @property
    def stats(self):
        return self.loop.stats

    def health_report(self, *, refresh: bool = True) -> dict | None:
        """Sketch-native health of the newest published snapshot.

        With the monitor running, ``refresh=True`` recomputes from the
        ring's latest version synchronously (blocks on its reduction —
        the reader cost, by design); ``refresh=False`` returns whatever
        the monitor last published. With metrics off, computes on
        demand. ``None`` before the first publish.
        """
        if self.ring.latest() is None:
            return None
        if self.health is not None:
            return (self.health.refresh() if refresh
                    else self.health.latest())
        return obs_health.sketch_health(
            self.ring.latest(), self.config.health_k_majority)

    def dump_flight_record(self, path: str | None = None,
                           reason: str = "on_demand") -> str | None:
        """Write the flight-recorder artifact now; returns its path
        (None when the recorder is disabled)."""
        if self.recorder is None:
            return None
        if self.sampler is not None:
            self.sampler.tick()     # the dump ends with a fresh frame
        else:
            self.recorder.capture()
        return self.recorder.dump(reason=reason, path=path)

    def describe(self) -> dict:
        """Config + consistent stats + metrics dump + sentinel state."""
        return {
            "workers": self.runtime.workers,
            "publish_every": self.publish_every,
            "ring_depth": self.ring.depth,
            "coalesce_max": self.coalesce_max,
            "feed_depth": self.feed_depth,
            "lazy_publish": self.lazy_publish,
            "queue_depth": self.config.queue_depth,
            "admission": self.config.admission,
            "latest_version": self.ring.latest_version,
            **self.stats.describe(),
            "metrics": self.registry.describe(),
            "health": (self.health.latest() if self.health is not None
                       else None),
            "drift": (self.drift.latest() if self.drift is not None
                      else None),
            "alerts": (self.alerts.describe() if self.alerts is not None
                       else None),
            "timeseries": (self.registry.timeseries.describe()
                           if self.sampler is not None else None),
            "flight": ({"frames": len(self.recorder.frames()),
                        "capacity": self.recorder.capacity,
                        "last_dump": self.recorder.last_dump_path}
                       if self.recorder is not None else None),
        }
