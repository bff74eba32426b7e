"""Alerts — declarative rules over time-series windows.

The counterpart of ``repro.obs.alerts``, a copy (numpy/Python only).
The decision layer of the drift sentinel (DESIGN.md §14): an
:class:`AlertRule` names one instrument, one windowed aggregate from
:mod:`repro_torch.obs.timeseries`, and a predicate; the
:class:`AlertManager` evaluates every rule each sampler tick against
the instrument's trailing window and runs the

    ``ok → pending → firing → resolved(→ ok)``

lifecycle. A breach must *hold* for ``for_s`` seconds before the rule
fires (pending absorbs one-tick spikes — a p99 blip is not an incident),
and a firing rule resolves on the first non-breaching evaluation.
Transitions — never steady states — are recorded as trace events
(``alert.fire`` / ``alert.resolve``), counted (``alerts.fired`` /
``alerts.resolved``), and mirrored into the ``alerts.active`` gauge, so
the alert stream itself is observable and replayable from a flight
record. ``on_fire`` hooks the flight recorder's first-critical trigger.

Rules see *windowed aggregates*, not raw samples, which is what makes
the defaults cheap to state: ingest-throughput regression is
``rate_ratio`` (trailing-window rate vs whole-history rate) of the
ingest block counter dipping, queue pressure is the mean sampled depth
nearing capacity, staleness is the health monitor's refresh age, and
saturation / skew-drift read the ``health.*`` / ``drift.*`` gauges the
reader-side monitors maintain. No rule ever touches the ingest path.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import typing

SEVERITIES = ("info", "warning", "critical")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative alert: fire when ``predicate(aggregate)`` holds
    for ``for_s`` seconds.

    ``metric`` names any instrument (counter, gauge, histogram) with a
    sampled history; ``aggregate`` is a :mod:`timeseries` window
    aggregate (``last``/``mean``/``rate``/``rate_ratio``/``p99``/...)
    evaluated over the trailing ``window_s`` seconds. A metric with no
    samples yet (or a NaN aggregate) evaluates to "no data", which
    never fires and never resolves — absence of telemetry is handled by
    the staleness rule, not by every rule at once.
    """

    name: str
    metric: str
    predicate: typing.Callable[[float], bool]
    aggregate: str = "last"
    window_s: float = 10.0
    for_s: float = 0.0
    severity: str = "warning"
    description: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got "
                f"{self.severity!r}")
        if self.for_s < 0:
            raise ValueError(f"for_s must be >= 0, got {self.for_s}")
        if self.window_s <= 0:
            raise ValueError(
                f"window_s must be > 0, got {self.window_s}")


# lifecycle states
OK, PENDING, FIRING = "ok", "pending", "firing"


class AlertManager:
    """Evaluates rules against a :class:`TimeSeriesStore` each tick.

    Single-evaluator discipline: ``evaluate()`` is called from the
    sampler pump (or a test) — it is lock-guarded and cheap (one store
    lookup per rule), but it is not meant to be raced from many
    threads. Readers (``active()``, ``transitions()``, ``describe()``)
    are safe from anywhere.
    """

    def __init__(self, store, registry, *, rules=(), tracer=None,
                 on_fire=None, transition_capacity: int = 256):
        from repro_torch.obs import trace as obs_trace
        self.store = store
        self.registry = registry
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.on_fire = on_fire
        self._rules: list[AlertRule] = []
        self._state: dict[str, dict] = {}
        self._transitions: collections.deque = collections.deque(
            maxlen=transition_capacity)
        self._lock = threading.Lock()
        self._fired = registry.counter("alerts.fired")
        self._resolved = registry.counter("alerts.resolved")
        self._active_gauge = registry.gauge("alerts.active")
        self._evals = registry.counter("alerts.evaluations")
        for r in rules:
            self.add_rule(r)

    # -- rule management -----------------------------------------------------

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if any(r.name == rule.name for r in self._rules):
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self._rules.append(rule)
            self._state[rule.name] = {"state": OK, "since": None,
                                      "value": None, "fired_count": 0}

    @property
    def rules(self) -> tuple:
        with self._lock:
            return tuple(self._rules)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, t: float | None = None) -> list[dict]:
        """One evaluation pass; returns the transitions it caused."""
        t = time.perf_counter() if t is None else t
        out = []
        with self._lock:
            self._evals.inc()
            for rule in self._rules:
                st = self._state[rule.name]
                v = self.store.value(rule.metric, rule.aggregate,
                                     rule.window_s)
                st["value"] = v
                if v is None:
                    continue                    # no data: hold state
                if rule.predicate(v):
                    if st["state"] == OK:
                        st["state"] = PENDING
                        st["since"] = t
                    if (st["state"] == PENDING
                            and t - st["since"] >= rule.for_s):
                        st["state"] = FIRING
                        st["fired_count"] += 1
                        out.append(self._transition(
                            rule, "fire", v, t, held_s=t - st["since"]))
                elif st["state"] != OK:
                    was_firing = st["state"] == FIRING
                    held = t - st["since"] if st["since"] else 0.0
                    st["state"] = OK
                    st["since"] = None
                    if was_firing:
                        out.append(self._transition(
                            rule, "resolve", v, t, held_s=held))
            self._active_gauge.set(sum(
                1 for s in self._state.values() if s["state"] == FIRING))
        for tr in out:                  # callbacks outside the lock
            if tr["transition"] == "fire" and self.on_fire is not None:
                self.on_fire(tr)
        return out

    def _transition(self, rule: AlertRule, kind: str, value, t,
                    held_s: float) -> dict:
        tr = {"transition": kind, "rule": rule.name,
              "metric": rule.metric, "aggregate": rule.aggregate,
              "severity": rule.severity, "value": value, "t": t,
              "epoch": time.time(), "held_s": held_s}
        self._transitions.append(tr)
        (self._fired if kind == "fire" else self._resolved).inc()
        self.tracer.event(f"alert.{kind}", rule=rule.name,
                          severity=rule.severity, value=value)
        return tr

    # -- reading -------------------------------------------------------------

    def active(self) -> list[dict]:
        """Currently-firing alerts, with their rule and last value."""
        with self._lock:
            return [{"rule": r.name, "severity": r.severity,
                     "metric": r.metric, "value": self._state[r.name]
                     ["value"], "since": self._state[r.name]["since"],
                     "fired_count": self._state[r.name]["fired_count"]}
                    for r in self._rules
                    if self._state[r.name]["state"] == FIRING]

    def transitions(self) -> list[dict]:
        """Recent fire/resolve transitions, oldest first."""
        with self._lock:
            return list(self._transitions)

    def describe(self) -> dict:
        with self._lock:
            return {r.name: {"state": self._state[r.name]["state"],
                             "severity": r.severity,
                             "metric": r.metric,
                             "aggregate": r.aggregate,
                             "value": self._state[r.name]["value"],
                             "fired_count": self._state[r.name]
                             ["fired_count"]}
                    for r in self._rules}


def default_rules(*, queue_depth: int = 8,
                  throughput_floor: float = 0.5,
                  queue_frac: float = 0.85,
                  staleness_s: float = 5.0,
                  epsilon_frac_max: float = 1.0 / 64,
                  skew_drift_max: float = 0.5) -> tuple:
    """The stock sentinel rule set (DESIGN.md §14).

    Thresholds are deliberately loose — these are "something is
    structurally wrong" tripwires, not SLO tuning — and every one can
    be replaced wholesale via ``ServeConfig.alert_rules``.
    """
    return (
        # trailing ingest rate collapsed vs the run's own history
        AlertRule("ingest_throughput_regression",
                  "serve.ingest.blocks", aggregate="rate_ratio",
                  window_s=2.0, for_s=1.0, severity="warning",
                  predicate=lambda v: v < throughput_floor,
                  description="trailing ingest block rate below "
                              f"{throughput_floor:.0%} of run average"),
        # sampled queue depth pinned near capacity: producers blocking
        AlertRule("queue_depth_pressure",
                  "serve.ingest.queue_depth", aggregate="mean",
                  window_s=2.0, for_s=1.0, severity="warning",
                  predicate=lambda v, _cap=queue_depth:
                  v >= queue_frac * _cap,
                  description="mean ingest queue depth near capacity"),
        # the health monitor stopped seeing publishes. Warning, not
        # critical: a quiescent tier (no submissions → no publishes)
        # ages this gauge too, and the stock rules must never trip the
        # flight recorder's first-critical auto-dump on a healthy idle
        # tier — promote it per deployment if ingest is always-on.
        AlertRule("health_staleness",
                  "health.last_refresh_age_s", aggregate="last",
                  window_s=staleness_s, for_s=0.0, severity="warning",
                  predicate=lambda v: v > staleness_s,
                  description="no health refresh off the ring for "
                              f"> {staleness_s:g}s"),
        # the live ε bound (m/n) approaching the k-majority threshold
        # scale 1/k': the guarantee split starts losing candidates.
        # (health.saturation itself grows ~linearly in n on any healthy
        # skewed stream, so a fixed cutoff there would always trip;
        # epsilon_frac is the accuracy-saturation signal that stays
        # flat unless the stream really outgrows the counter budget)
        AlertRule("sketch_saturation",
                  "health.epsilon_frac", aggregate="last",
                  window_s=staleness_s, for_s=0.0, severity="warning",
                  predicate=lambda v: v > epsilon_frac_max,
                  description="live eps bound (min_count/n) past "
                              f"{epsilon_frac_max:g} — k-majority "
                              "guarantees eroding"),
        # estimated stream skew moved between publishes: drift
        AlertRule("skew_drift",
                  "drift.skew_drift", aggregate="last",
                  window_s=staleness_s, for_s=0.0, severity="warning",
                  predicate=lambda v: abs(v) > skew_drift_max,
                  description="estimated zipf skew jumped between "
                              "consecutive publishes"),
    )
