"""Drift — online stream-skew estimation from the sketch's own counters.

The counterpart of ``repro.obs.drift``: numpy over a host copy of each
refreshed snapshot (one device→host copy an update, through
:func:`repro_torch.obs.health.host_copy`, counted in its ``HOST_COPIES``).

The Hurwitz-zeta companion paper (arXiv:1401.0702) proves Space Saving's
error bound is a *function of the stream's zipf skew*: the more skewed
the stream, the smaller the minimum counter m (the live ε) relative to
the uniform worst case n/k. That turns the sketch's counter distribution
into a live accuracy signal — estimate the skew from the counters the
sketch already holds, map it through the bound, and you can see accuracy
drifting before any oracle could tell you (DESIGN.md §14). Everything
here is pure numpy over a published :class:`QuerySnapshot`; nothing
touches the ingest path.

Four estimators, refreshed off ring publishes by the
:class:`~repro_torch.obs.health.HealthMonitor` (reader-side, like every other
health read):

  * **zipf-skew fit** (:func:`fit_zipf_skew`) — the top counters of a
    zipf(s) stream follow f̂ᵢ ≈ (n/Z)·i^(−s), so log f̂ vs log rank is a
    line with slope −s. The fit uses only ranks whose sketch error is a
    small fraction of the counter (f̂ − e ≫ ε ranks; tail counters are
    error-dominated and would flatten the slope), and reports a
    block-jackknife confidence interval: leave-one-rank-block-out
    refits capture the systematic rank-range sensitivity (curvature,
    finite support) that i.i.d. residual errors understate — validated
    to cover the generator's true s across the committed bench profiles
    (the drift phase of the JAX package's ``launch/bench_obs.py`` gates
    exactly this).
  * **predicted ε** (:func:`predicted_min_count`) — the 1401.0702-style
    bound evaluated at the estimated skew: counters sum to n and the
    top-j zipf frequencies occupy j counters, so
    m ≤ min_j (n − Σ_{i≤j} f_i)/(k − j) with f_i = n·i^(−s)/ζ(s) (the
    zeta tail summed exactly to k and integral-bounded beyond).
    Comparing the sketch's ACTUAL min-count ε against the skew-predicted
    bound answers "is the sketch behaving like the stream it claims to
    see" — actual/predicted drifting past 1 means the stream is less
    skewed than estimated (or adversarial), and reported accuracy
    should not be trusted at the estimated-skew level.
  * **top-n churn** — fraction of the top-n identity set replaced
    between consecutive publishes: rank-stability of the heavy hitters,
    the query-side freshness signal QPOPSS (arXiv:2409.01749) argues
    must be monitored rather than assumed.
  * **saturation burn rate** — d(saturation)/dt and d(occupancy)/dt
    from consecutive refreshes, projected to time-to-full /
    time-to-saturation: how long until the counter budget k stops
    covering the stream at current pressure (the capacity signal
    ROADMAP item 3's skew-adaptive k will act on).

All outputs are exported as ``drift.*`` gauges plus a plain dict
(``DriftEstimator.latest()``) surfaced through ``ServingTier.describe()``
and the flight recorder.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np

from repro_torch.core.spacesaving import EMPTY

# fit discipline (calibrated against the committed bench profiles):
# counters whose error exceeds ERR_FRAC of their count are too
# sketch-noisy to carry rank information; 8 clean ranks minimum, 256 cap
# (beyond that the fit gains nothing and the jackknife blocks thin out).
FIT_MAX_RANKS = 256
FIT_MIN_RANKS = 8
FIT_ERR_FRAC = 0.1
_JACKKNIFE_BLOCKS = 8
_T_CRIT = 2.4           # ~t(0.975, df=7) for the 8-block jackknife


def _ols_slope(x: np.ndarray, y: np.ndarray) -> float:
    xm, ym = x.mean(), y.mean()
    return float(((x - xm) * (y - ym)).sum() / ((x - xm) ** 2).sum())


def fit_zipf_skew(counts, errors=None, *,
                  max_ranks: int = FIT_MAX_RANKS,
                  min_ranks: int = FIT_MIN_RANKS,
                  err_frac: float = FIT_ERR_FRAC) -> dict:
    """Log-log rank fit of the zipf skew s over a counter distribution.

    ``counts``/``errors`` are the (k,) summary channels (EMPTY slots may
    be zeroed or carried — zero counts are dropped). Returns::

        {"s": ŝ, "ci_low": ., "ci_high": ., "stderr": .,
         "ranks_used": R, "r2": .}

    with ``s = nan`` (and zero ranks) when fewer than ``min_ranks``
    usable ranks exist — an unsaturated or near-empty sketch has no
    rank structure to fit, and callers must treat that as "no signal",
    not "skew zero".
    """
    c = np.asarray(counts, dtype=np.float64).reshape(-1)
    e = (np.zeros_like(c) if errors is None
         else np.asarray(errors, dtype=np.float64).reshape(-1))
    order = np.argsort(-c)
    c, e = c[order], e[order]
    live = c > 0
    c, e = c[live], e[live]

    # the longest clean prefix of ranks: error a small fraction of count
    limit = min(c.shape[0], max_ranks)
    R = 0
    for i in range(limit):
        if e[i] <= err_frac * c[i]:
            R = i + 1
        else:
            break
    R = max(R, min(min_ranks, c.shape[0]))
    nan = float("nan")
    if R < min_ranks:
        return {"s": nan, "ci_low": nan, "ci_high": nan, "stderr": nan,
                "ranks_used": 0, "r2": nan}

    x = np.log(np.arange(1, R + 1, dtype=np.float64))
    y = np.log(c[:R])
    slope = _ols_slope(x, y)
    s_hat = -slope
    yhat = y.mean() + slope * (x - x.mean())
    ss_res = float(((y - yhat) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else nan

    # block jackknife over contiguous rank blocks: the spread of
    # leave-one-block-out slopes prices in the systematic rank-range
    # sensitivity an i.i.d.-residual stderr misses
    n_blocks = min(_JACKKNIFE_BLOCKS, R // 2)
    if n_blocks >= 2:
        blocks = np.array_split(np.arange(R), n_blocks)
        jk = np.empty(n_blocks)
        for b, idx in enumerate(blocks):
            mask = np.ones(R, dtype=bool)
            mask[idx] = False
            jk[b] = -_ols_slope(x[mask], y[mask])
        var = (n_blocks - 1) / n_blocks * ((jk - jk.mean()) ** 2).sum()
        stderr = float(np.sqrt(var))
    else:                           # pragma: no cover - min_ranks >= 8
        stderr = nan
    half = _T_CRIT * stderr if math.isfinite(stderr) else nan
    return {"s": s_hat, "ci_low": s_hat - half, "ci_high": s_hat + half,
            "stderr": stderr, "ranks_used": R, "r2": r2}


def zeta(s: float, lo: int = 1, terms: int = 4096) -> float:
    """ζ(s) partial sum from ``lo`` with an integral tail bound
    (the Hurwitz-zeta ζ(s, lo) for s > 1, to ~1e-6 relative)."""
    if s <= 1.0:
        return float("inf")
    hi = lo + terms
    head = float((np.arange(lo, hi, dtype=np.float64) ** -s).sum())
    # ∫_{hi-1/2}^∞ x^-s dx — midpoint tail, tighter than the right sum
    tail = (hi - 0.5) ** (1.0 - s) / (s - 1.0)
    return head + tail


def predicted_min_count(n: int, k: int, s: float) -> float:
    """The skew-predicted ε bound of 1401.0702's analysis.

    Counters sum to n, and the j counters monitoring the top-j zipf
    frequencies hold at least f_i = n·i^(−s)/ζ(s) each, so the minimum
    counter obeys  m ≤ min_{0≤j<k} (n − Σ_{i≤j} f_i) / (k − j).
    Returns the bound (≤ n/k always — j=0 recovers the skew-free
    worst case); nan when s has no finite zeta (s ≤ 1: the infinite-
    support zipf law does not normalize, and the uniform n/k bound is
    the only safe statement)."""
    if not (math.isfinite(s) and s > 1.0) or n <= 0 or k < 1:
        return float("nan")
    z = zeta(s)
    ranks = np.arange(1, k, dtype=np.float64)
    head = np.concatenate([[0.0], np.cumsum(ranks ** -s) / z])  # j = 0..k-1
    remaining = n * (1.0 - head)
    free = k - np.arange(0, k, dtype=np.float64)
    return float(np.min(remaining / free))


def top_n_churn(prev_items, cur_items) -> float:
    """Fraction of the current top-n identity set NOT in the previous
    one (0 = stable heavy hitters, 1 = full turnover)."""
    cur = np.asarray(cur_items).reshape(-1)
    cur = cur[cur != EMPTY]
    if cur.size == 0:
        return 0.0
    prev = np.asarray(prev_items).reshape(-1)
    fresh = ~np.isin(cur, prev[prev != EMPTY])
    return float(fresh.sum() / cur.size)


# gauge-exported scalar fields of one drift frame
_GAUGE_FIELDS = ("skew", "skew_ci_low", "skew_ci_high", "skew_drift",
                 "predicted_min_count", "epsilon_vs_predicted",
                 "top_churn", "occupancy_burn_per_s",
                 "saturation_burn_per_s", "time_to_full_s",
                 "time_to_saturation_s")


class DriftEstimator:
    """Stateful per-tier drift frames, refreshed off ring publishes.

    ``update(snap, health)`` computes one frame from a materialized
    snapshot (pure numpy — call from a reader context, exactly like
    ``sketch_health``), exports the scalar fields as ``drift.*`` gauges,
    and keeps the previous frame's identity set / clock for the
    between-publish estimators (churn, burn rates, skew drift). One
    update at a time; stale versions are skipped like HealthGauges.
    """

    def __init__(self, registry, *, top_n: int = 32,
                 prefix: str = "drift"):
        self.registry = registry
        self.top_n = int(top_n)
        self.prefix = prefix
        self._lock = threading.Lock()
        self._latest: dict | None = None
        self._prev_top: np.ndarray | None = None

    def latest(self) -> dict | None:
        return self._latest

    def update(self, snap, health: dict | None = None,
               t: float | None = None) -> dict:
        from repro_torch.obs.health import host_copy, sketch_health
        if health is None:
            health = sketch_health(snap)
        t = time.perf_counter() if t is None else t
        items, counts, errors = host_copy(*snap.summary)
        live = items != EMPTY
        counts = np.where(live, counts, 0)

        fit = fit_zipf_skew(counts, errors)
        n, k = int(health["n"]), int(health["k"])
        pred = predicted_min_count(n, k, fit["s"])
        actual = float(health["min_count"])
        nan = float("nan")

        order = np.argsort(-counts)[:self.top_n]
        top = items.reshape(-1)[order]
        top = top[counts.reshape(-1)[order] > 0]

        frame = {
            "version": int(health["version"]),
            "t": t,
            "n": n,
            "k": k,
            "skew": fit["s"],
            "skew_ci_low": fit["ci_low"],
            "skew_ci_high": fit["ci_high"],
            "skew_stderr": fit["stderr"],
            "skew_ranks_used": fit["ranks_used"],
            "skew_r2": fit["r2"],
            "skew_drift": nan,
            "predicted_min_count": pred,
            "actual_min_count": actual,
            # >1 = worse than the skew-predicted bound: the stream is
            # less zipfian than its head looks (accuracy alarm signal)
            "epsilon_vs_predicted": (actual / pred) if pred and
            math.isfinite(pred) and pred > 0 else nan,
            "top_churn": nan,
            "occupancy_burn_per_s": nan,
            "saturation_burn_per_s": nan,
            "time_to_full_s": nan,
            "time_to_saturation_s": nan,
        }

        with self._lock:
            prev = self._latest
            if prev is not None and frame["version"] <= prev["version"]:
                # same snapshot (or older): the stored frame already
                # carries the between-publish deltas a recompute from
                # one version cannot — keep it
                return prev
            if prev is not None and frame["version"] > prev["version"]:
                dt = t - prev["t"]
                if math.isfinite(prev.get("skew", nan)) and (
                        math.isfinite(fit["s"])):
                    frame["skew_drift"] = fit["s"] - prev["skew"]
                if self._prev_top is not None:
                    frame["top_churn"] = top_n_churn(self._prev_top, top)
                if dt > 0:
                    occ_rate = (health["occupancy_frac"]
                                - prev.get("occupancy_frac", nan)) / dt
                    sat_rate = (health["saturation"]
                                - prev.get("saturation", nan)) / dt
                    frame["occupancy_burn_per_s"] = occ_rate
                    frame["saturation_burn_per_s"] = sat_rate
                    headroom = 1.0 - health["occupancy_frac"]
                    if headroom <= 0:
                        frame["time_to_full_s"] = 0.0
                    elif math.isfinite(occ_rate) and occ_rate > 0:
                        frame["time_to_full_s"] = headroom / occ_rate
                    else:
                        frame["time_to_full_s"] = float("inf")
                    sat_head = 1.0 - health["saturation"]
                    if sat_head <= 0:
                        frame["time_to_saturation_s"] = 0.0
                    elif math.isfinite(sat_rate) and sat_rate > 0:
                        frame["time_to_saturation_s"] = sat_head / sat_rate
                    else:
                        frame["time_to_saturation_s"] = float("inf")
            # carried for the next frame's deltas
            frame["occupancy_frac"] = health["occupancy_frac"]
            frame["saturation"] = health["saturation"]
            for field in _GAUGE_FIELDS:
                v = frame[field]
                if isinstance(v, float) and not math.isfinite(v):
                    continue        # gauges carry finite signals only
                self.registry.gauge(f"{self.prefix}.{field}").set(v)
            self._latest = frame
            self._prev_top = top
        return frame
