"""repro_torch.obs against repro.obs: the same calls, the same answers.

The metrics, time-series and trace modules are copies, so every export is
compared exactly on the same call sequence: ``describe()`` dicts,
Prometheus text, percentiles, windowed aggregates (the rings wrapping
around included), and trace events apart from their times, pids and
thread ids. Then the counters that the engine, the PlanService and the
StreamRuntime record into the process registry: on the same calls, from
the same plan-cache state, both packages move the same counters by the
same amounts (an ``ingest`` that auto-flushes counts no flush in either).
The engines pin their kernel: under ``'auto'`` the port memoizes an
engine's resolutions and routes the flush by shape (``ops.resolve_window_impl``),
so its ``plan.*`` counts there differ by design.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

import repro.plan as jplan
from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import StreamRuntime as JRuntime
from repro_torch import plan as tplan
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import timeseries as ttimeseries
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import RuntimeConfig, StreamRuntime

torch.set_num_threads(1)

BOUNDS = (0.5, 1.0, 2.0, 4.0, 8.0)


def _nan_safe(x):
    """JSON text of ``x`` with NaN spelled out, so equal NaNs compare equal."""
    return json.dumps(x, sort_keys=True, allow_nan=True)


def _record(m, seed: int) -> None:
    """One call sequence on registry module ``m`` (JAX's or the port's)."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    reg.counter("engine.flush_calls").inc()
    reg.counter("serve.ingest.blocks").inc(int(rng.integers(1, 50)))
    reg.gauge("serve.queue.depth").set(float(rng.integers(0, 9)))
    lat = reg.histogram("serve.ingest.step_s")
    for v in 10.0 ** rng.uniform(-7, 3, 200):        # below, inside, above the edges
        lat.record(float(v))
    sizes = reg.histogram("serve.block.items", BOUNDS)
    for v in rng.integers(0, 12, 50):
        sizes.record(float(v))
    reg.histogram("serve.read.empty_s")               # never recorded
    reg.counter('weird name/"q"').inc(3)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_equal(seed):
    j, t = _record(jmetrics, seed), _record(tmetrics, seed)
    assert _nan_safe(j.describe()) == _nan_safe(t.describe())
    assert j.prometheus() == t.prometheus()
    assert j.names() == t.names()
    for name in ("serve.ingest.step_s", "serve.block.items", "serve.read.empty_s"):
        jh, th = j.histogram(name), t.histogram(name)
        for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
            a, b = jh.percentile(q), th.percentile(q)
            assert a == b or (math.isnan(a) and math.isnan(b)), (name, q)
        assert jh.buckets() == th.buckets()
        assert jh.raw() == th.raw()
    assert tmetrics.log_bounds(1e-3, 10, 4) == jmetrics.log_bounds(1e-3, 10, 4)
    assert tmetrics.prom_sample("a.b", {"le": 'x"\\\n'}, 1) == \
        jmetrics.prom_sample("a.b", {"le": 'x"\\\n'}, 1)


def _pump(m, capacity: int):
    """A registry sampled at fixed times 0..14 while its instruments move."""
    reg = m.MetricsRegistry(series_capacity=capacity)
    c, g = reg.counter("rt.blocks"), reg.gauge("rt.depth")
    h = reg.histogram("rt.step_s", BOUNDS)
    for t in range(15):
        c.inc(t % 4)
        g.set(float((t * 7) % 5))
        for v in (0.3 * t, 1.5 + t % 3, 9.0 * (t % 2)):
            h.record(v)
        reg.sample(float(t))
    return reg


@pytest.mark.parametrize("capacity", [3, 8, 64])
def test_timeseries_windows_equal(capacity):
    """capacity 3 and 8 wrap the rings around; 64 holds every sample."""
    j, t = _pump(jmetrics, capacity), _pump(tmetrics, capacity)
    js, ts = j.timeseries, t.timeseries
    assert js.names() == ts.names() and js.samples == ts.samples == 15
    for window in (None, 0.5, 2.5, 6.0, 100.0):
        assert _nan_safe(js.describe(window)) == _nan_safe(ts.describe(window))
        for name in js.names():
            for agg in ("last", "delta", "rate", "mean", "min", "max", "p50", "p99",
                        "rate_ratio"):
                if agg == "rate_ratio" and window is None:
                    continue
                assert _nan_safe(js.value(name, agg, window)) == \
                    _nan_safe(ts.value(name, agg, window)), (name, agg, window)
    for name in js.names():
        (jt, jv), (tt, tv) = js.get(name).rows(), ts.get(name).rows()
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(jv, tv)


def test_sampler_tick_and_null_store():
    reg = tmetrics.MetricsRegistry(series_capacity=4)
    reg.counter("a").inc()
    seen = []
    sampler = ttimeseries.MetricsSampler(reg, interval_s=60.0, on_sample=seen.append)
    assert sampler.tick(1.0) == 1.0 and seen == [1.0]
    assert reg.timeseries.samples == 1
    with pytest.raises(ValueError, match="interval_s"):
        ttimeseries.MetricsSampler(reg, interval_s=0)
    assert tmetrics.NULL.timeseries is ttimeseries.NULL_STORE
    assert tmetrics.NULL.sample(1.0) is None


def _schema(events):
    drop = ("t", "dur_s", "epoch", "pid", "tid")
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _trace(m, printed):
    tr = m.Tracer(capacity=6)
    with tr.span("ingest", block=1):
        with tr.span("flush"):
            tr.event("flushed", tenants=4)
        tr.log("step", _printer=printed.append, rate=1.5e9, n=3)
    for i in range(3):
        with tr.span("snapshot", version=i):
            pass
    return tr


def test_trace_event_schema_equal():
    jp, tp = [], []
    j, t = _trace(jtrace, jp), _trace(ttrace, tp)
    assert jp == tp == ["[step] rate=1.5e+09 n=3"]
    assert _schema(j.events()) == _schema(t.events())      # the ring kept 6 of 8
    assert len(t.events()) == 6
    for since in (0, 4, 7):
        assert _schema(map(json.loads, j.export(since_event_id=since).splitlines())) == \
            _schema(map(json.loads, t.export(since_event_id=since).splitlines()))
    assert _schema(map(json.loads, t.to_jsonl(last=2).splitlines())) == \
        _schema(t.events()[-2:])
    assert sorted(t.events()[0]) == sorted(j.events()[0])  # the same keys, times too


def test_annotated_span_shows_on_the_profiler():
    tr = ttrace.Tracer(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("runtime.phase"):
            torch.ones(8).sum()
    assert "runtime.phase" in {e.key for e in prof.key_averages()}
    assert tr.events()[-1]["name"] == "runtime.phase"


@pytest.mark.parametrize("m", [jmetrics, tmetrics], ids=["repro", "repro_torch"])
def test_null_registry_hands_out_shared_noops(m):
    null = m.NULL
    assert null.counter("a") is null.counter("b")
    assert null.gauge("a") is null.gauge("b")
    assert null.histogram("a") is null.histogram("b", BOUNDS)
    null.counter("a").inc(5)
    null.histogram("a").record(1.0)
    with null.histogram("a").time():
        pass
    assert null.describe() == {} and null.prometheus() == ""
    assert null.counter("a").value == 0 and null.histogram("a").count == 0
    assert ttrace.NULL.span("x").__enter__() == 0 and ttrace.NULL.events() == []


# ---------------------------------------------------------------------------
# the counters of the engine, the PlanService and the runtime
# ---------------------------------------------------------------------------

COUNTERS = ("engine.flush_calls", "engine.snapshot_publishes",
            "plan.active_resolutions", "plan.installed_hits", "plan.env_hits",
            "plan.cache_hits", "plan.static_fallbacks", "plan.impl_resolutions",
            "runtime.feed.blocks", "runtime.snapshot_publishes")


def _values(reg):
    """Every counter of COUNTERS and the step histogram's count, 0 where the
    process has not created the instrument yet: which ones exist depends on
    the tests that ran before in the same worker."""
    d = reg.describe()
    out = {n: d[n]["value"] if n in d else 0 for n in COUNTERS}
    out["runtime.feed.step_s"] = (d["runtime.feed.step_s"]["count"]
                                  if "runtime.feed.step_s" in d else 0)
    return out


def _delta(reg, calls):
    before = _values(reg)
    calls()
    after = _values(reg)
    return {n: v - before.get(n, 0) for n, v in after.items()}


@pytest.fixture
def plan_caches(tmp_path, monkeypatch):
    """Both packages resolve against empty plan caches of their own."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "torch"))
    monkeypatch.delenv("REPRO_PLAN_FILE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    jplan.clear(), tplan.clear()
    yield tmp_path
    jplan.clear(), tplan.clear()


def _engine_calls(engine, stream):
    def calls():
        st = engine.ingest(engine.init(), stream)        # 5 chunks: an auto-flush
        st = engine.update(st, stream[:, :32])           # fill 2 → 3: another
        st = engine.flush(st)
        engine.flush(engine.update(st, stream[:, :10]))
        engine.snapshot(st)
        engine.snapshot(st, lazy=True)
    return calls


def _plan_calls(svc, cpu, plan_for_this_device, monkeypatch, tmp_path, env_var):
    """Every precedence branch of the PlanService, in turn."""
    def calls():
        args = (cpu,) if cpu else ()
        svc.active_plan(*args)                                  # static
        svc.resolve_impl("combine", 64, *args)
        svc.resolve_reduction(4, *args)
        svc.planned_engine_config(64, **({"device": cpu} if cpu else {}))
        plan = plan_for_this_device()
        with svc.use_plan(plan):                                # installed
            svc.active_plan(*args)
            svc.resolve_impl("query", 2048, *args)
        path = plan.save(svc.plan_path(plan.fingerprint))       # cache
        svc.clear()
        svc.active_plan(*args)
        svc.resolve_impl("update", 256, *args)
        monkeypatch.setenv(env_var, str(path))                  # env
        svc.active_plan(*args)
        monkeypatch.delenv(env_var)
        path.unlink()
        svc.clear()
    return calls


def test_engine_counters_equal(rng):
    stream = np.minimum(rng.zipf(1.3, (3, 5 * 32 - 7)), 400).astype(np.int32)
    geom = dict(k=64, tenants=3, chunk=32, buffer_depth=3)
    je = JEngine(JConfig(kernel="jnp", **geom))
    te = SketchEngine(EngineConfig(kernel="torch", device="cpu", **geom))
    jd = _delta(jmetrics.DEFAULT, _engine_calls(je, jax.numpy.asarray(stream)))
    td = _delta(tmetrics.DEFAULT, _engine_calls(te, stream))
    assert jd == td
    assert td["engine.flush_calls"] == 2 and td["engine.snapshot_publishes"] == 2
    # an ingest that auto-flushes counts no flush, in either package
    assert _delta(tmetrics.DEFAULT, lambda: te.ingest(te.init(), stream)) == \
        _delta(jmetrics.DEFAULT, lambda: je.ingest(je.init(), stream)) == \
        {n: 0 for n in td}


def test_plan_counters_equal(plan_caches, monkeypatch):
    j = _plan_calls(jplan, None, lambda: jplan.static_plan(jplan.device_fingerprint()),
                    monkeypatch, plan_caches, "REPRO_PLAN_FILE")
    t = _plan_calls(tplan.service, "cpu",
                    lambda: tplan.static_plan(tplan.device_fingerprint("cpu")),
                    monkeypatch, plan_caches, "REPRO_TORCH_PLAN_FILE")
    jd, td = _delta(jmetrics.DEFAULT, j), _delta(tmetrics.DEFAULT, t)
    assert jd == td
    assert {n: td[n] for n in COUNTERS if n.startswith("plan.")} == {
        "plan.active_resolutions": 9, "plan.installed_hits": 2, "plan.env_hits": 1,
        "plan.cache_hits": 2, "plan.static_fallbacks": 4, "plan.impl_resolutions": 3}


def test_runtime_counters_equal(plan_caches):
    geom = dict(k=64, tenants=4, chunk=32, buffer_depth=2)
    jrt = JRuntime(JRuntimeConfig(engine=JConfig(kernel="jnp", **geom), shards=1))
    trt = StreamRuntime(RuntimeConfig(
        engine=EngineConfig(kernel="torch", device="cpu", **geom), shards=1))
    blocks = [zipf_stream(n, 1.1, seed=i, max_id=10**4)
              for i, n in enumerate((4 * 32, 0, 4 * 64, 50))]

    def calls(rt):
        def run():
            st = rt.feed(rt.init(), iter(blocks))
            rt.snapshot(st)
            rt.snapshot(st, lazy=True)
        return run

    jd, td = _delta(jmetrics.DEFAULT, calls(jrt)), _delta(tmetrics.DEFAULT, calls(trt))
    assert jd == td
    assert td["runtime.feed.blocks"] == td["runtime.feed.step_s"] == 3
    assert td["runtime.snapshot_publishes"] == 2
