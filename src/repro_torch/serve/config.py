"""ServeConfig — policy knobs of the concurrent serving tier.

The counterpart of ``repro.serve.config``. Every ``resolved_*`` asks the
plan of the runtime's engine device (``active_plan(device)``).

Wraps a :class:`~repro_torch.runtime.RuntimeConfig` (topology + engine policy —
the write side) with the serving-tier decisions the runtime deliberately
does not own: how often the ingest loop publishes a snapshot to the ring,
how many versions the ring keeps, how deep the admission queue is, and
what happens when it fills.

``publish_every`` and ``ring_depth`` default to ``None`` → the active
:class:`~repro_torch.plan.ExecutionPlan`'s measured values (the ``"publish"``
probe op of ``python -m repro_torch.launch.tune`` sizes the cadence so snapshot
reductions cost a bounded fraction of ingest throughput — DESIGN.md
§11.3), with the documented static fallback when no plan is cached. An
explicit integer pins the knob, same precedence rule as every other
"auto" in the stack.

Admission policy on a full queue:

  ``"block"``  the submitting producer waits (backpressure propagates
               upstream — the default, lossless);
  ``"shed"``   the block is dropped and counted
               (``IngestStats.blocks_shed``) — for producers that must
               never stall and can tolerate sampled ingestion.

The drift-sentinel knobs (``timeseries`` / ``drift`` / ``alerts`` /
``flight_recorder``, DESIGN.md §14) are all gated under ``metrics``:
with ``metrics=False`` the tier composes the NULL registry and none of
the sentinel machinery exists — that arm is the overhead gate's
baseline (the JAX package's ``launch/bench_obs.py``).

``flight_path`` defaults to ``flight_record.json`` in the current
directory; callers that must not write there point it elsewhere.
"""
from __future__ import annotations

import dataclasses

from repro_torch.plan import active_plan
from repro_torch.runtime.config import RuntimeConfig

ADMISSION_POLICIES = ("block", "shed")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static configuration of one :class:`~repro_torch.serve.ServingTier`."""

    runtime: RuntimeConfig = RuntimeConfig()
    publish_every: int | None = None   # ingested blocks per ring publish;
                                       # None → the active plan's cadence
    ring_depth: int | None = None      # SnapshotRing slots; None → plan
    coalesce_max: int | None = None    # max queued blocks ingested as ONE
                                       # coalesced dispatch; None → plan
                                       # (static fallback 1 — per-block)
    lazy_publish: bool | None = None   # defer the snapshot reduction to
                                       # the first reader; None → plan
                                       # (static fallback False — eager)
    queue_depth: int = 8               # bounded admission queue (blocks)
    admission: str = "block"           # 'block' | 'shed' on queue-full
    metrics: bool = True               # tier-local registry + spans +
                                       # health monitor (False → no-op
                                       # instruments, the overhead gate's
                                       # metrics-off arm)
    health_k_majority: int = 64        # k' for the guarantee-split
                                       # health gauges (DESIGN.md §12)
    timeseries: bool = True            # ring-buffer metric histories +
                                       # the fixed-interval sampler pump
    sample_interval_s: float = 0.25    # sampler tick (history
                                       # resolution; ring covers
                                       # series_capacity ticks)
    series_capacity: int = 512         # samples kept per instrument
    drift: bool = True                 # online skew / ε-bound / churn
                                       # estimation off ring publishes
    alerts: bool = True                # rule engine on sampler ticks
    alert_rules: tuple | None = None   # None → obs.alerts.default_rules
                                       # sized to queue_depth; () → none
    flight_recorder: bool = True       # postmortem ring + dump triggers
    flight_path: str = "flight_record.json"  # dump artifact location

    def __post_init__(self):
        if self.publish_every is not None and self.publish_every < 1:
            raise ValueError(
                f"publish_every must be >= 1 or None, got "
                f"{self.publish_every}")
        if self.ring_depth is not None and self.ring_depth < 1:
            raise ValueError(
                f"ring_depth must be >= 1 or None, got {self.ring_depth}")
        if self.coalesce_max is not None and self.coalesce_max < 1:
            raise ValueError(
                f"coalesce_max must be >= 1 or None, got "
                f"{self.coalesce_max}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission {self.admission!r} not in "
                             f"{ADMISSION_POLICIES}")
        if self.health_k_majority < 1:
            raise ValueError(
                f"health_k_majority must be >= 1, got "
                f"{self.health_k_majority}")
        if self.sample_interval_s <= 0:
            raise ValueError(
                f"sample_interval_s must be > 0, got "
                f"{self.sample_interval_s}")
        if self.series_capacity < 2:
            raise ValueError(
                f"series_capacity must be >= 2, got "
                f"{self.series_capacity}")

    def resolved_alert_rules(self) -> tuple:
        """The rule set the tier's AlertManager loads (None → stock
        :func:`~repro_torch.obs.alerts.default_rules` sized to this queue)."""
        if self.alert_rules is not None:
            return tuple(self.alert_rules)
        from repro_torch.obs.alerts import default_rules
        return default_rules(queue_depth=self.queue_depth,
                             epsilon_frac_max=1.0 / self.health_k_majority)

    def resolved_publish_every(self) -> int:
        """Blocks between ring publishes (None → the plan's cadence)."""
        if self.publish_every is not None:
            return self.publish_every
        return active_plan(self.runtime.engine.device).publish_every

    def resolved_ring_depth(self) -> int:
        """SnapshotRing depth (None → the plan's measured depth)."""
        if self.ring_depth is not None:
            return self.ring_depth
        return active_plan(self.runtime.engine.device).ring_depth

    def resolved_coalesce_max(self) -> int:
        """Max blocks per coalesced ingest dispatch (None → plan)."""
        if self.coalesce_max is not None:
            return self.coalesce_max
        return active_plan(self.runtime.engine.device).coalesce_max

    def resolved_lazy_publish(self) -> bool:
        """Whether ring publishes defer their reduction (None → plan)."""
        if self.lazy_publish is not None:
            return self.lazy_publish
        return active_plan(self.runtime.engine.device).lazy_publish
