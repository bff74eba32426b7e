"""repro_torch's sentinel layer against repro's, on the CPU.

Health (``sketch_health``, ``HealthGauges``, ``HealthMonitor``), drift
(``fit_zipf_skew``, ``zeta``, ``predicted_min_count``, ``top_n_churn``,
``DriftEstimator``), alerts (``AlertManager`` over a scripted time series,
``default_rules``), the flight recorder (``FlightRecorder``,
``validate_flight_record``) and ``eval.accuracy.oracle_free_invariants``:
each fed the same inputs in both packages — snapshots of the same numpy
stream through the JAX engine (``kernel="jnp"``/``"sorted"``) and the port
(``"torch"``/``"sorted"``) — and held equal. Integers and the floats
computed from them in numpy are compared exactly (NaN equal to NaN).
"""
import json
import math
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro.eval.accuracy import oracle_free_invariants as j_invariants
from repro.obs import drift as jdrift
from repro.service import QueryFrontend as JFrontend
from repro_torch import obs as tobs
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.eval.accuracy import oracle_free_invariants
from repro_torch.obs import drift as tdrift
from repro_torch.obs import health as thealth
from repro_torch.obs.recorder import FRAME_KEYS, _jsonable
from repro_torch.serve import RingPublisher, ServeConfig, ServingTier, SnapshotRing
from repro_torch.service import QueryFrontend

torch.set_num_threads(1)

K, B, CHUNK, DEPTH = 128, 4, 256, 2
IMPLS = [("jnp", "torch"), ("sorted", "sorted")]


def _engines(jk="jnp", tk="torch", k=K):
    return (JEngine(JConfig(k=k, tenants=B, chunk=CHUNK, buffer_depth=DEPTH, kernel=jk)),
            SketchEngine(EngineConfig(k=k, tenants=B, chunk=CHUNK, buffer_depth=DEPTH,
                                      kernel=tk, device="cpu")))


def _stream(n, skew=1.3, seed=0):
    return zipf_stream(B * n, skew, seed=seed, max_id=10**5).reshape(B, n)


def _snapshots(n, skew=1.3, seed=0, jk="jnp", tk="torch", k=K):
    """The JAX and the port snapshot of the same stream."""
    jeng, teng = _engines(jk, tk, k)
    s = _stream(n, skew, seed)
    return (jeng.snapshot(jeng.ingest(jeng.init(), jnp.asarray(s))),
            teng.snapshot(teng.ingest(teng.init(), torch.from_numpy(s))))


def _same(a, b):
    """Equal, with NaN equal to NaN, through dicts and lists."""
    if isinstance(a, dict):
        assert set(a) == set(b), (set(a) ^ set(b))
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b and type(a) is type(b), (a, b)


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jk,tk", IMPLS)
@pytest.mark.parametrize("n,k_majority", [(300, None), (300, 16), (5_000, 64),
                                          (5_000, 1000), (40, 8)])
def test_sketch_health_equals_jax(jk, tk, n, k_majority):
    """n 40 leaves the summaries partly free (min_count 0), 5 000 fills them."""
    jsnap, tsnap = _snapshots(n, jk=jk, tk=tk)
    before = thealth.HOST_COPIES
    got = tobs.sketch_health(tsnap, k_majority)
    assert thealth.HOST_COPIES == before + 1            # one copy a refresh
    _same(jobs.sketch_health(jsnap, k_majority), got)


def test_host_copy_is_one_copy_of_every_tensor():
    ts = [torch.arange(5, dtype=torch.int32), torch.tensor(7, dtype=torch.int64),
          torch.arange(6, dtype=torch.int64).reshape(2, 3)]
    out = thealth.host_copy(*ts)
    for t, a in zip(ts, out):
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape)
        np.testing.assert_array_equal(a, t.numpy())


@pytest.mark.parametrize("jk,tk", IMPLS)
def test_health_gauges_equal_jax_and_skip_stale(jk, tk):
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jg, tg = jobs.HealthGauges(jreg, k_majority=32), tobs.HealthGauges(treg, k_majority=32)
    jeng, teng = _engines(jk, tk)
    s = _stream(3_000, seed=1)
    jst, tst = jeng.init(), teng.init()
    snaps = []
    for i in range(3):
        part = s[:, i * 1000:(i + 1) * 1000]
        jst = jeng.ingest(jst, jnp.asarray(part))
        tst = teng.ingest(tst, torch.from_numpy(part))
        snaps.append((jeng.snapshot(jst), teng.snapshot(tst)))
        _same(jg.update(snaps[-1][0]), tg.update(snaps[-1][1]))
    # an older version never overwrites the newer gauges
    _same(jg.update(snaps[0][0]), tg.update(snaps[0][1]))
    assert tg.skipped_stale == jg.skipped_stale == 1
    _same(jreg.describe(), treg.describe())


def test_health_monitor_refreshes_off_the_ring_and_defers_lazy():
    _, teng = _engines()
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    rt = StreamRuntime(RuntimeConfig(engine=teng.config, shards=1))
    ring = SnapshotRing(depth=4)
    reg = tobs.MetricsRegistry()
    drift = tobs.DriftEstimator(reg)
    mon = tobs.HealthMonitor(ring, reg, k_majority=16, poll_s=0.01, drift=drift).start()
    pub = RingPublisher(rt, ring)
    state = rt.init()
    try:
        for i in range(3):
            state = rt.ingest(state, _stream(500, seed=10 + i).reshape(-1))
            pub.publish(state)
        deadline = time.perf_counter() + 10
        while (drift.latest() is None or drift.latest()["version"] < 3) \
                and time.perf_counter() < deadline:
            ring.wait_for(3, timeout=0.01)
        assert mon.latest()["version"] == 3
        _same(mon.latest(), tobs.sketch_health(ring.latest(), 16))
        assert drift.latest()["version"] == 3
        lazy = pub.publish(state, lazy=True, n_hint=int(state.n.sum()))
        deadline = time.perf_counter() + 10
        while reg.counter("obs.health.deferred").value < 1 and time.perf_counter() < deadline:
            ring.wait_for(4, timeout=0.01)
        assert reg.counter("obs.health.deferred").value >= 1
        assert not lazy.materialized        # the monitor is not the reader that forces it
    finally:
        mon.stop()
    assert mon.latest()["version"] == 4 and lazy.materialized   # stop() refreshes the newest


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_true", [1.1, 1.5, 2.0])
def test_fit_zipf_skew_equals_jax_on_sketch_counters(s_true):
    jsnap, tsnap = _snapshots(20_000, skew=s_true, seed=int(s_true * 10))
    fits = []
    for fit, summary in ((jobs.fit_zipf_skew, [np.asarray(a) for a in jsnap.summary]),
                         (tobs.fit_zipf_skew, [a.numpy() for a in tsnap.summary])):
        items, counts, errors = summary
        fits.append(fit(np.where(items != -1, counts, 0), errors))
    _same(*fits)
    assert fits[1]["ranks_used"] >= 8
    _same(jobs.fit_zipf_skew(np.zeros(64)), tobs.fit_zipf_skew(np.zeros(64)))
    _same(jobs.fit_zipf_skew([5.0, 3.0, 1.0]), tobs.fit_zipf_skew([5.0, 3.0, 1.0]))


@pytest.mark.parametrize("s", [0.9, 1.0, 1.1, 1.5, 2.0, float("nan")])
@pytest.mark.parametrize("n,k", [(10**6, 256), (5_000, 64), (0, 8)])
def test_predicted_min_count_and_zeta_equal_jax(s, n, k):
    _same(jdrift.predicted_min_count(n, k, s), tdrift.predicted_min_count(n, k, s))
    if not math.isnan(s):
        _same(jdrift.zeta(s), tdrift.zeta(s))
        _same(jdrift.zeta(s, lo=3, terms=100), tdrift.zeta(s, lo=3, terms=100))


@pytest.mark.parametrize("prev,cur", [([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [4, 5, 6]),
                                      ([1, 2, 3, 4], [1, 2, 9]), ([1, 2], []),
                                      ([-1, 4], [4, -1, 7])])
def test_top_n_churn_equals_jax(prev, cur):
    _same(jobs.top_n_churn(prev, cur), tobs.top_n_churn(prev, cur))


@pytest.mark.parametrize("jk,tk", IMPLS)
def test_drift_estimator_frames_equal_jax(jk, tk):
    """Frames over three publishes at scripted times, a repeated version
    and a stale one; then the gauges both registries hold."""
    jeng, teng = _engines(jk, tk)
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jest, test_ = jobs.DriftEstimator(jreg, top_n=16), tobs.DriftEstimator(treg, top_n=16)
    s = _stream(9_000, skew=1.5, seed=5)
    jst, tst = jeng.init(), teng.init()
    snaps = []
    for i, t in enumerate((10.0, 20.0, 25.0)):
        part = s[:, i * 3000:(i + 1) * 3000]
        jst = jeng.ingest(jst, jnp.asarray(part))
        tst = teng.ingest(tst, torch.from_numpy(part))
        snaps.append((jeng.snapshot(jst), teng.snapshot(tst)))
        _same(jest.update(snaps[-1][0], t=t), test_.update(snaps[-1][1], t=t))
    _same(jest.update(snaps[1][0], t=30.0), test_.update(snaps[1][1], t=30.0))
    _same(jest.latest(), test_.latest())
    _same(jreg.describe(), treg.describe())


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------

def _rules(pkg):
    return [pkg.AlertRule("hot", "pressure", lambda v: v > 10, for_s=5.0,
                          severity="critical", window_s=30.0),
            pkg.AlertRule("spiky", "pressure", lambda v: v > 40, for_s=2.0),
            pkg.AlertRule("mean_high", "pressure", lambda v: v > 20,
                          aggregate="mean", window_s=3.0),
            pkg.AlertRule("ghost", "does.not.exist", lambda v: True)]


SCRIPT = [(0.0, 1.0), (1.0, 50.0), (2.0, 45.0), (3.0, 30.0), (6.5, 50.0),
          (7.0, 0.0), (8.0, 60.0), (9.0, 5.0), (15.0, 12.0), (21.0, 12.0)]


def test_alert_manager_transitions_equal_jax_over_a_scripted_series():
    runs = {}
    for name, pkg in (("jax", jobs), ("port", tobs)):
        reg, tracer = pkg.MetricsRegistry(), pkg.Tracer()
        g = reg.gauge("pressure")
        fired = []
        mgr = pkg.AlertManager(reg.timeseries, reg, rules=_rules(pkg), tracer=tracer,
                               on_fire=fired.append)
        steps = []
        for t, v in SCRIPT:
            g.set(v)
            reg.sample(t)
            steps.append([{k: x for k, x in tr.items() if k != "epoch"}
                          for tr in mgr.evaluate(t)])
        runs[name] = (steps, mgr.describe(), mgr.active(),
                      [e["name"] for e in tracer.events()],
                      [f["rule"] for f in fired],
                      {n: reg.counter(n).value for n in ("alerts.fired", "alerts.resolved",
                                                          "alerts.evaluations")},
                      reg.gauge("alerts.active").value)
    _same(runs["jax"], runs["port"])
    assert any(runs["port"][0])             # the script does fire and resolve


def test_default_rules_equal_jax():
    for kw in ({}, {"queue_depth": 4, "epsilon_frac_max": 1 / 16}):
        jr, tr = jobs.default_rules(**kw), tobs.default_rules(**kw)
        assert [(r.name, r.metric, r.aggregate, r.window_s, r.for_s, r.severity)
                for r in jr] == [(r.name, r.metric, r.aggregate, r.window_s, r.for_s,
                                  r.severity) for r in tr]
        for value in (0.0, 0.3, 0.9, 3.5, 6.0, 100.0):
            assert [r.predicate(value) for r in jr] == [r.predicate(value) for r in tr]


def test_alert_rule_validation():
    with pytest.raises(ValueError, match="severity"):
        tobs.AlertRule("x", "m", lambda v: True, severity="apocalyptic")
    with pytest.raises(ValueError, match="for_s"):
        tobs.AlertRule("x", "m", lambda v: True, for_s=-1)
    with pytest.raises(ValueError, match="window_s"):
        tobs.AlertRule("x", "m", lambda v: True, window_s=0)
    reg = tobs.MetricsRegistry()
    mgr = tobs.AlertManager(reg.timeseries, reg, rules=[tobs.AlertRule("a", "m", bool)])
    with pytest.raises(ValueError, match="duplicate"):
        mgr.add_rule(tobs.AlertRule("a", "m", bool))


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _recorded(pkg, path):
    reg = pkg.MetricsRegistry()
    reg.counter("c").inc(3)
    reg.gauge("g").set(float("nan"))
    reg.histogram("h").record(0.02)
    rec = pkg.FlightRecorder(reg, capacity=4, path=str(path),
                             health_source=lambda: {"n": np.int64(5), "f": float("inf")},
                             drift_source=lambda: None)
    for i in range(10):
        rec.capture(float(i))
    return rec


def test_flight_recorder_equals_jax_and_validates_across(tmp_path):
    records = {}
    for name, pkg in (("jax", jobs), ("port", tobs)):
        rec = _recorded(pkg, tmp_path / f"{name}.json")
        assert len(rec.frames()) == 4 and rec.frames()[0]["t"] == 6.0
        path = rec.dump(reason="test")
        records[name] = json.loads(open(path).read())
    jobs.validate_flight_record(records["port"])
    tobs.validate_flight_record(records["jax"])

    def stable(r):
        drop = ("epoch", "pid")
        return {k: ([{fk: fv for fk, fv in f.items() if fk != "epoch"} for f in v]
                    if k == "frames" else v) for k, v in r.items() if k not in drop}

    _same(stable(records["jax"]), stable(records["port"]))
    for frame in records["port"]["frames"]:
        assert set(FRAME_KEYS) <= set(frame)
    assert records["port"]["health"] == {"n": 5, "f": None}


def test_flight_recorder_rejects_incomplete_records():
    with pytest.raises(ValueError, match="dict"):
        tobs.validate_flight_record([])
    with pytest.raises(ValueError, match="missing"):
        tobs.validate_flight_record({"schema": "x"})
    rec = _recorded(tobs, "unused.json").build()
    tobs.validate_flight_record(rec)
    bad = dict(rec, schema="other/v9")
    with pytest.raises(ValueError, match="schema"):
        tobs.validate_flight_record(bad)
    bad = dict(rec, frames=[{"t": 0.0}])
    with pytest.raises(ValueError, match="frame 0"):
        tobs.validate_flight_record(bad)


def test_jsonable_takes_tensors():
    got = _jsonable({"a": torch.tensor([1, 2]), "b": torch.tensor(float("nan")),
                     "c": np.float32(1.5), "d": torch.tensor(3, dtype=torch.int64),
                     "e": (torch.tensor([[1.0, float("inf")]]),)})
    assert got == {"a": [1, 2], "b": None, "c": 1.5, "d": 3, "e": [[[1.0, None]]]}
    json.dumps(got, allow_nan=False)


def test_recorder_auto_dumps_once_on_error_and_critical_alert(tmp_path):
    rec = _recorded(tobs, tmp_path / "crash.json")
    assert rec.on_alert({"severity": "warning", "rule": "w"}) is None
    path = rec.on_error(RuntimeError("boom"))
    record = tobs.validate_flight_record(json.loads(open(path).read()))
    assert record["reason"] == "ingest_error" and record["error"]["type"] == "RuntimeError"
    assert rec.on_alert({"severity": "critical", "rule": "c"}) is None   # once only


# ---------------------------------------------------------------------------
# oracle-free invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jk,tk", IMPLS)
@pytest.mark.parametrize("n,k_majority", [(5_000, 64), (5_000, 16), (40, 8), (2_000, 512)])
def test_oracle_free_invariants_equal_jax_and_health(jk, tk, n, k_majority):
    jsnap, tsnap = _snapshots(n, skew=1.2, seed=3, jk=jk, tk=tk)
    jrep = JFrontend(jk).k_majority_report(jsnap, k_majority)
    trep = QueryFrontend(tk).k_majority_report(tsnap, k_majority)
    got = oracle_free_invariants(tsnap, trep)
    _same(j_invariants(jsnap, jrep), got)
    health = tobs.sketch_health(tsnap, k_majority)
    _same({key: health[key] for key in got}, got)


# ---------------------------------------------------------------------------
# the sentinel composed in the tier
# ---------------------------------------------------------------------------

def _runtime():
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    return StreamRuntime(RuntimeConfig(engine=EngineConfig(
        k=64, tenants=2, chunk=128, buffer_depth=2, kernel="torch", device="cpu"),
        shards=1))


def _serve_config(rt, tmp_path, **kw):
    kw.setdefault("flight_path", str(tmp_path / "flight.json"))
    return ServeConfig(runtime=rt.config, publish_every=2, ring_depth=3,
                       sample_interval_s=0.01, **kw)


class _Poison:
    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("sentinel test induced failure")


def test_tier_sentinel_surface_and_on_demand_dump(tmp_path):
    rt = _runtime()
    with ServingTier(_serve_config(rt, tmp_path), runtime=rt) as tier:
        assert tier.sampler is not None and tier.sampler.running
        assert tier.drift is not None and tier.alerts is not None
        for i in range(6):
            tier.submit(zipf_stream(rt.workers * 128, 1.3, seed=40 + i, max_id=10**5))
        tier.drain()
        assert tier.health_report()["n"] == 6 * rt.workers * 128
        path = tier.dump_flight_record()
        desc = tier.describe()
    assert not tier.sampler.running
    record = tobs.validate_flight_record(json.loads(open(path).read()))
    assert record["reason"] == "on_demand" and len(record["frames"]) >= 1
    assert desc["drift"] is not None and desc["drift"]["n"] > 0
    assert desc["alerts"] and "health_staleness" in desc["alerts"]
    assert desc["flight"]["last_dump"] == path


def test_tier_induced_error_dumps_flight_record(tmp_path):
    rt = _runtime()
    path = str(tmp_path / "crash.json")
    tier = ServingTier(_serve_config(rt, tmp_path, flight_path=path), runtime=rt).start()
    tier.submit(zipf_stream(rt.workers * 128, 1.3, seed=9, max_id=10**5))
    tier.drain()
    tier.submit(_Poison())
    done = threading.Event()
    deadline = time.perf_counter() + 10.0
    while tier.recorder.last_dump_path is None and time.perf_counter() < deadline:
        done.wait(0.01)
    with pytest.raises(RuntimeError):
        tier.stop(drain=False)
    assert tier.recorder.last_dump_path == path
    record = tobs.validate_flight_record(json.loads(open(path).read()))
    assert record["reason"] == "ingest_error"
    assert "induced failure" in record["error"]["traceback"]
    assert not tier.sampler.running and not tier.health.running


def test_tier_metrics_off_builds_no_sentinel(tmp_path):
    rt = _runtime()
    with ServingTier(_serve_config(rt, tmp_path, metrics=False), runtime=rt) as tier:
        tier.submit(zipf_stream(rt.workers * 128, 1.3, seed=1, max_id=10**5))
        snap = tier.drain()
        assert tier.health_report()["n"] == int(snap.n)     # computed on demand
    assert tier.sampler is None and tier.drift is None
    assert tier.alerts is None and tier.recorder is None and tier.health is None
    assert tier.dump_flight_record() is None


def test_tier_sentinel_knobs_gate_pieces(tmp_path):
    rt = _runtime()
    tier = ServingTier(_serve_config(rt, tmp_path, timeseries=False, drift=False,
                                     alerts=False, flight_recorder=False), runtime=rt)
    assert tier.sampler is None and tier.drift is None
    assert tier.alerts is None and tier.recorder is None
    assert tier.health is not None
