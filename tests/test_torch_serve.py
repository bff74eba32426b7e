"""repro_torch.serve against repro.serve, on the CPU.

The port's counterparts of ``tests/test_serve.py``: ring semantics
(monotonic versions, pinned reads and eviction, ``wait_for``, concurrent
reads never torn, depth 64), the tier's drained snapshot bitwise equal to
the JAX tier's on the same blocks and to the port's synchronous ingest
(impls ``torch``/``sorted`` against the JAX ``jnp``/``sorted``, coalesced
and not), publish cadence, shed and backpressure admission, error
propagation, idempotent stop, sync and async answers, ServeConfig
validation and plan resolution, and lazy snapshots held across later
ingests. Tolerance 0 throughout; no test passes or fails on a timing.
"""
import asyncio
import dataclasses
import functools
import queue
import threading
import types

import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro.serve as jserve
from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro_torch.engine import EngineConfig, SketchState
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.plan import active_plan, clear, use_plan
from repro_torch.runtime import DeviceStager, RuntimeConfig, StreamRuntime, host_blocks
from repro_torch.serve import (IngestLoop, IngestStats, RingPublisher, ServeConfig,
                               ServeFrontend, ServingTier, SnapshotRing,
                               StaleSnapshotError, fence)

torch.set_num_threads(1)

K, LANES, CHUNK, DEPTH = 64, 2, 128, 2
IMPLS = [("jnp", "torch"), ("sorted", "sorted")]


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


def _runtime(kernel="torch"):
    return StreamRuntime(RuntimeConfig(
        engine=EngineConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH,
                            kernel=kernel, device="cpu"), shards=1))


@functools.lru_cache(maxsize=None)
def _jruntime(kernel):
    return jrt.StreamRuntime(jrt.RuntimeConfig(
        engine=JConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH,
                       kernel=kernel), shards=1))


def _config(rt, tmp_path, **kw):
    kw.setdefault("publish_every", 2)
    kw.setdefault("ring_depth", 3)
    return ServeConfig(runtime=rt.config, flight_path=str(tmp_path / "flight.json"),
                       sample_interval_s=0.01, **kw)


def _blocks(n_blocks, seed=0, workers=LANES):
    return [zipf_stream(workers * CHUNK, 1.1, seed=seed + i, max_id=10**4)
            for i in range(n_blocks)]


def _snap(version):
    """A minimal immutable stand-in snapshot for pure ring tests."""
    return types.SimpleNamespace(version=version, n=1000 + version)


def _summaries_equal(a, b):
    for name, x, y in zip(("items", "counts", "errors"), a.summary, b.summary):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"summary.{name}")
    assert int(a.n) == int(b.n)


def _sync_snapshot(rt, blocks):
    state = rt.init()
    for b in blocks:
        state = rt.ingest(state, host_blocks(b, rt.workers, CHUNK))
    return rt.snapshot(state)


# ---------------------------------------------------------------------------
# SnapshotRing semantics
# ---------------------------------------------------------------------------

def test_ring_versions_strictly_monotonic():
    ring = SnapshotRing(depth=2)
    assert ring.latest() is None and ring.latest_version == 0
    ring.publish(_snap(1))
    ring.publish(_snap(2))
    assert ring.latest_version == 2
    with pytest.raises(ValueError, match="not after"):
        ring.publish(_snap(2))
    with pytest.raises(ValueError, match="not after"):
        ring.publish(_snap(1))
    assert ring.latest_version == 2
    with pytest.raises(ValueError, match="depth"):
        SnapshotRing(depth=0)


def test_ring_pinned_get_and_eviction():
    ring = SnapshotRing(depth=2)
    for v in (1, 2, 3, 4):
        ring.publish(_snap(v))
    assert ring.get(4).version == 4 and ring.get(3).version == 3
    for stale in (1, 2, 5):
        with pytest.raises(StaleSnapshotError):
            ring.get(stale)


def test_ring_wait_for():
    ring = SnapshotRing(depth=2)
    with pytest.raises(TimeoutError):
        ring.wait_for(1, timeout=0.01)
    t = threading.Timer(0.01, lambda: ring.publish(_snap(1)))
    t.start()
    assert ring.wait_for(1, timeout=10.0).version == 1
    t.join()


def test_ring_concurrent_reads_never_torn_or_backwards():
    ring = SnapshotRing(depth=4)
    stop = threading.Event()
    errors: list = []

    def read():
        seen = 0
        while not stop.is_set():
            snap = ring.latest()
            if snap is None:
                continue
            if snap.n != 1000 + snap.version:
                errors.append(("torn", snap.version, snap.n))
            if snap.version < seen:
                errors.append(("backwards", seen, snap.version))
            seen = snap.version
            try:
                if ring.get(snap.version).version != snap.version:
                    errors.append(("wrong-pin", snap.version))
            except StaleSnapshotError:
                pass                            # eviction race: detected, ok

    readers = [threading.Thread(target=read) for _ in range(2)]
    for t in readers:
        t.start()
    for v in range(1, 200):
        ring.publish(_snap(v))
        if v % 50 == 0:
            stop.wait(0.001)                    # let starved readers run
    stop.set()
    for t in readers:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors[:5]
    assert ring.latest_version == 199


def test_ring_depth_64_dict_index():
    ring = SnapshotRing(depth=64)
    for v in range(1, 201):
        ring.publish(_snap(v))
    assert ring.latest_version == 200
    for v in range(137, 201):
        assert ring.get(v).version == v
    for v in (1, 100, 136):
        with pytest.raises(StaleSnapshotError):
            ring.get(v)


def test_fence_wraps_nothing_on_the_cpu():
    snap = _snap(3)
    assert fence(snap, "cpu") is snap


# ---------------------------------------------------------------------------
# the tier: served ≡ JAX tier ≡ synchronous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jk,tk", IMPLS)
@pytest.mark.parametrize("coalesce", [1, 4, 64])
def test_tier_equals_jax_tier_and_sync_ingest(tmp_path, jk, tk, coalesce):
    """64 exceeds the queue depth: every drain coalesces maximally."""
    blocks = _blocks(7)
    rt = _runtime(tk)
    ref = _sync_snapshot(rt, blocks)
    with ServingTier(_config(rt, tmp_path, publish_every=3, coalesce_max=coalesce),
                     runtime=rt) as tier:
        for b in blocks:
            assert tier.submit(b)
        snap = tier.drain()
        assert tier.ring.latest().version == snap.version
        stats = tier.stats.describe()
    _summaries_equal(ref, snap)
    assert stats["blocks_ingested"] == 7
    assert stats["publishes"] == 4      # initial + after blocks 3 and 6 + drain

    jcfg = jserve.ServeConfig(runtime=_jruntime(jk).config, publish_every=3,
                              ring_depth=3, coalesce_max=coalesce, metrics=False)
    with jserve.ServingTier(jcfg, runtime=_jruntime(jk)) as jtier:
        for b in blocks:
            jtier.submit(b)
        jsnap = jtier.drain()
        jstats = jtier.stats.describe()
    _summaries_equal(jsnap, snap)
    assert jstats == stats


@pytest.mark.parametrize("kernel", ["torch", "sorted", "fused"])
def test_tier_bitwise_identical_to_sync_ingest(tmp_path, kernel):
    """fused on the CPU runs the fused kernels' plain versions."""
    rt = _runtime(kernel)
    blocks = _blocks(5, seed=3)
    ref = _sync_snapshot(rt, blocks)
    with ServingTier(_config(rt, tmp_path), runtime=rt) as tier:
        for b in blocks:
            assert tier.submit(b)
        snap = tier.drain()
    _summaries_equal(ref, snap)


def test_tier_leaves_the_callers_state_unchanged(tmp_path):
    """The loop writes into a copy of a caller-provided mid-window state."""
    rt = _runtime()
    blocks = _blocks(4, seed=5)
    start = rt.ingest(rt.init(), host_blocks(blocks[0], rt.workers, CHUNK))
    assert start.fill == 1
    before = [t.clone() for t in (*start.summary, start.buffer, start.n)]
    ring = SnapshotRing(depth=4)
    loop = IngestLoop(rt, ring, publish_every=8, state=start).start()
    for b in blocks[1:]:
        loop.submit(b)
    snap = loop.stop()
    for a, b in zip(before, (*start.summary, start.buffer, start.n)):
        assert torch.equal(a, b)
    _summaries_equal(_sync_snapshot(rt, blocks), snap)


def test_publish_cadence_counts(tmp_path):
    rt = _runtime()
    with ServingTier(_config(rt, tmp_path, publish_every=2), runtime=rt) as tier:
        for b in _blocks(5):
            tier.submit(b)
        snap = tier.drain()
        stats = tier.stats
        assert stats.publishes == 4      # initial + after 2 and 4 + the drain
        assert stats.blocks_submitted == stats.blocks_ingested == 5
        assert stats.items_ingested == 5 * rt.workers * CHUNK
        assert stats.blocks_shed == 0
        assert tier.ring.latest_version == snap.version
        reg = tier.registry
        assert reg.counter("serve.ingest.blocks").value == 5
        assert reg.counter("serve.ingest.items").value == 5 * rt.workers * CHUNK
        assert reg.histogram("serve.ingest.publish_s").count == 4


def test_shed_admission_counts_drops():
    rt = _runtime()
    loop = IngestLoop(rt, SnapshotRing(depth=2), publish_every=4, queue_depth=1,
                      admission="shed")          # not started: the queue only fills
    assert loop.submit(np.arange(8, dtype=np.int32)) is True
    assert loop.submit(np.arange(8, dtype=np.int32)) is False
    assert loop.stats.blocks_shed == 1
    assert loop.stats.blocks_submitted == 1
    assert loop.registry.counter("serve.ingest.shed").value >= 1


def test_block_admission_backpressure_timeout():
    rt = _runtime()
    loop = IngestLoop(rt, SnapshotRing(depth=2), publish_every=4, queue_depth=1,
                      admission="block")
    assert loop.submit(np.arange(8, dtype=np.int32))
    with pytest.raises(queue.Full):
        loop.submit(np.arange(8, dtype=np.int32), timeout=0.01)


@pytest.mark.parametrize("kw,match", [
    (dict(publish_every=0), "publish_every"), (dict(admission="drop"), "admission"),
    (dict(coalesce_max=0), "coalesce_max"), (dict(feed_depth=0), "feed_depth")])
def test_loop_validation(kw, match):
    kw.setdefault("publish_every", 4)
    with pytest.raises(ValueError, match=match):
        IngestLoop(_runtime(), SnapshotRing(depth=2), **kw)


def test_loop_error_propagates_to_producers():
    rt = _runtime()
    seen = []
    loop = IngestLoop(rt, SnapshotRing(depth=2), publish_every=4,
                      on_error=seen.append).start()
    # a 3-d payload cannot be block-decomposed: the loop thread dies with
    # the real exception chained, and every later producer call reports it
    loop.submit(np.zeros((2, 3, 4), dtype=np.int32))
    with pytest.raises(RuntimeError, match="IngestLoop"):
        loop.drain(timeout=10)
    with pytest.raises(RuntimeError):
        loop.submit(np.arange(8, dtype=np.int32))
    assert len(seen) == 1 and isinstance(seen[0], ValueError)


def test_tier_stop_is_idempotent(tmp_path):
    rt = _runtime()
    tier = ServingTier(_config(rt, tmp_path), runtime=rt).start()
    tier.submit(_blocks(1)[0])
    snap = tier.stop()
    assert snap is not None and int(snap.n) == rt.workers * CHUNK
    assert tier.stop() is None
    with pytest.raises(RuntimeError, match="stopped"):
        tier.submit(_blocks(1)[0])


def test_concurrent_producers_lose_no_block(tmp_path):
    """Four producers submit at once (a 10 µs interpreter switch interval
    forces interleaving): every block is counted and ingested exactly once,
    and the drained sketch has every item."""
    import sys
    rt = _runtime()
    blocks = _blocks(24, seed=40)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServingTier(_config(rt, tmp_path, publish_every=3, coalesce_max=4),
                         runtime=rt) as tier:
            producers = [threading.Thread(target=lambda part=blocks[i::4]: [
                tier.submit(b) for b in part]) for i in range(4)]
            for t in producers:
                t.start()
            for t in producers:
                t.join(timeout=60)
                assert not t.is_alive()
            snap = tier.drain()
            stats = tier.stats.describe()
    finally:
        sys.setswitchinterval(old)
    assert stats["blocks_submitted"] == stats["blocks_ingested"] == 24
    assert stats["items_ingested"] == int(snap.n) == 24 * rt.workers * CHUNK


def test_ingest_stats_describe_is_consistent():
    stats = IngestStats()
    stats.add(blocks_ingested=2, items_ingested=10)
    assert stats.describe() == {"blocks_submitted": 0, "blocks_shed": 0,
                                "blocks_ingested": 2, "items_ingested": 10,
                                "publishes": 0}
    with pytest.raises(AttributeError):
        stats.add(nope=1)


# ---------------------------------------------------------------------------
# ServeFrontend
# ---------------------------------------------------------------------------

def test_frontend_sync_and_async_answers_match(tmp_path):
    rt = _runtime()
    with ServingTier(_config(rt, tmp_path), runtime=rt) as tier:
        for b in _blocks(4):
            tier.submit(b)
        snap = tier.drain()
        est = tier.frontend.estimate([1, 2, 3], min_version=snap.version)
        top = tier.frontend.top_table(3, min_version=snap.version)
        rep = tier.frontend.k_majority_report(16, min_version=snap.version)
        assert est.version == top.version == rep.version == snap.version
        assert est.n == top.n == rep.n == int(snap.n)
        assert (est.lower <= est.f_hat).all()

        async def roundtrip():
            return await asyncio.gather(
                tier.frontend.aestimate([1, 2, 3], min_version=snap.version),
                tier.frontend.atop_table(3, min_version=snap.version),
                tier.frontend.ak_majority_report(16, min_version=snap.version))

        aest, atop, arep = asyncio.run(roundtrip())
        np.testing.assert_array_equal(aest.f_hat, est.f_hat)
        assert atop.rows == top.rows
        np.testing.assert_array_equal(arep.guaranteed_items, rep.guaranteed_items)
        for op in ("point", "top", "kmaj"):
            assert tier.registry.histogram(f"serve.read.{op}_s").count == 2


@pytest.mark.parametrize("jk,tk", IMPLS)
def test_frontend_answers_equal_jax(tmp_path, jk, tk):
    blocks = _blocks(4, seed=11)
    rt = _runtime(tk)
    with ServingTier(_config(rt, tmp_path, metrics=False), runtime=rt) as tier:
        for b in blocks:
            tier.submit(b)
        tier.drain()
        got = (tier.frontend.estimate(np.arange(40, dtype=np.int32)),
               tier.frontend.top_table(8), tier.frontend.k_majority_report(16))
    jcfg = jserve.ServeConfig(runtime=_jruntime(jk).config, publish_every=2,
                              ring_depth=3, metrics=False)
    with jserve.ServingTier(jcfg, runtime=_jruntime(jk)) as jtier:
        for b in blocks:
            jtier.submit(b)
        jtier.drain()
        want = (jtier.frontend.estimate(np.arange(40, dtype=np.int32)),
                jtier.frontend.top_table(8), jtier.frontend.k_majority_report(16))
    for field in ("f_hat", "lower", "monitored"):
        np.testing.assert_array_equal(getattr(got[0], field), getattr(want[0], field))
    assert got[1].rows == want[1].rows and got[1].n == want[1].n
    # versions count each runtime's publishes; the cached JAX runtime has made more
    assert ({k: v for k, v in got[2].describe().items() if k != "version"}
            == {k: v for k, v in want[2].describe().items() if k != "version"})
    np.testing.assert_array_equal(got[2].candidate_items, want[2].candidate_items)


def test_frontend_times_out_before_first_publish():
    rt = _runtime()
    frontend = ServeFrontend(SnapshotRing(depth=2), rt.frontend())
    with pytest.raises(TimeoutError):
        frontend.estimate([1, 2], timeout=0.01)


def test_frontend_resolution_floor_fast_path():
    """estimate(resolution <= count_floor) answers from publish-time scalars:
    a lazy snapshot stays unmaterialized; one notch above takes the real path."""
    rt = _runtime()
    state = rt.init()
    for b in _blocks(4):
        state = rt.ingest(state, host_blocks(b, rt.workers, CHUNK))
    n = int(state.n.sum())
    floor = n // K
    assert floor >= 1
    ring = SnapshotRing(depth=2)
    RingPublisher(rt, ring).publish(state, lazy=True, n_hint=n)
    snap = ring.latest()
    reg = MetricsRegistry()
    fe = ServeFrontend(ring, rt.frontend(), registry=reg)
    est = fe.estimate([1, 2, 3], resolution=floor)
    assert snap.materialized is False
    assert est.n == n and est.version == snap.version
    np.testing.assert_array_equal(est.f_hat, np.full(3, floor, dtype=np.int64))
    assert not est.lower.any() and not est.monitored.any()
    assert reg.counter("serve.read.floor_answers").value == 1
    est2 = fe.estimate([1, 2, 3], resolution=floor + 1)
    assert snap.materialized is True
    assert (est2.f_hat >= est2.lower).all()
    assert reg.counter("serve.read.floor_answers").value == 1


# ---------------------------------------------------------------------------
# config + plan knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(admission="drop"), "admission"), (dict(queue_depth=0), "queue_depth"),
    (dict(publish_every=0), "publish_every"), (dict(ring_depth=-1), "ring_depth"),
    (dict(coalesce_max=0), "coalesce_max"), (dict(health_k_majority=0), "health_k"),
    (dict(sample_interval_s=0), "sample_interval"), (dict(series_capacity=1), "series")])
def test_serve_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw)


def test_serve_config_resolves_through_the_plan_of_its_device():
    cpu = EngineConfig(k=K, tenants=LANES, device="cpu")
    cfg = ServeConfig(runtime=RuntimeConfig(engine=cpu))
    static = active_plan("cpu")
    assert (cfg.resolved_publish_every(), cfg.resolved_ring_depth(),
            cfg.resolved_coalesce_max(), cfg.resolved_lazy_publish()) == (
        static.publish_every, static.ring_depth, static.coalesce_max,
        static.lazy_publish) == (8, 4, 1, False)
    plan = dataclasses.replace(static, publish_every=7, ring_depth=5, coalesce_max=6,
                               feed_depth=3, lazy_publish=True)
    with use_plan(plan):
        assert cfg.resolved_publish_every() == 7
        assert cfg.resolved_ring_depth() == 5
        assert cfg.resolved_coalesce_max() == 6
        assert cfg.resolved_lazy_publish() is True
        assert cfg.runtime.resolved_feed_depth() == 3
        pinned = dataclasses.replace(cfg, publish_every=3, ring_depth=2, coalesce_max=2,
                                     lazy_publish=False)
        assert pinned.resolved_publish_every() == 3
        assert pinned.resolved_ring_depth() == 2
        assert pinned.resolved_coalesce_max() == 2
        assert pinned.resolved_lazy_publish() is False


def test_serve_config_alert_rules():
    cfg = ServeConfig(queue_depth=4, health_k_majority=16)
    rules = cfg.resolved_alert_rules()
    assert {r.name for r in rules} >= {"queue_depth_pressure", "sketch_saturation"}
    sat = next(r for r in rules if r.name == "sketch_saturation")
    assert sat.predicate(1 / 15) and not sat.predicate(1 / 17)
    assert ServeConfig(alert_rules=()).resolved_alert_rules() == ()


# ---------------------------------------------------------------------------
# lazy publishes and buffer ownership (the port's donation fence)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["torch", "sorted"])
def test_runtime_lazy_snapshot_bitwise_eager(kernel):
    rt = _runtime(kernel)
    state = rt.init()
    for b in _blocks(3):
        state = rt.ingest(state, host_blocks(b, rt.workers, CHUNK))
    eager = rt.snapshot(state)
    n = int(state.n.sum())
    fired = []
    lazy = rt.snapshot(state, lazy=True, n_hint=n, on_materialize=lambda: fired.append(1))
    assert lazy.materialized is False
    assert lazy.count_floor == n // K
    assert lazy.materialized is False and not fired
    _summaries_equal(eager, lazy)
    assert lazy.materialized is True and fired == [1]
    lazy.materialize()
    assert fired == [1]


@pytest.mark.parametrize("kernel", ["torch", "sorted"])
@pytest.mark.parametrize("lazy_publish", [True, False])
def test_snapshot_held_across_ingests_equals_eager_of_its_position(tmp_path, kernel,
                                                                   lazy_publish):
    """Hold a (lazy) snapshot taken mid-window, ingest far past its ring
    eviction, then read it: bitwise the eager snapshot of that position."""
    rt = _runtime(kernel)
    blocks = _blocks(9, seed=20)
    # 3 blocks of 2 chunks a lane: the held position is mid-window (fill 1)
    ref = _sync_snapshot(rt, blocks[:3])
    cfg = _config(rt, tmp_path, publish_every=1, ring_depth=2, lazy_publish=lazy_publish)
    with ServingTier(cfg, runtime=rt) as tier:
        for b in blocks[:3]:
            tier.submit(b)
        held = tier.drain()
        assert held.materialized is (not lazy_publish)
        for b in blocks[3:]:
            tier.submit(b)
        final = tier.drain()
        with pytest.raises(StaleSnapshotError):
            tier.ring.get(held.version)
    _summaries_equal(ref, held)
    assert held.materialized is True
    _summaries_equal(_sync_snapshot(rt, blocks), final)


def test_stager_carries_meta():
    stager = DeviceStager(device="cpu", depth=2)
    stager.stage(np.arange(4, dtype=np.int32), (1, 4))
    stager.stage(np.arange(6, dtype=np.int32))
    assert stager.room == 0
    dev, meta = stager.take()
    assert meta == (1, 4) and dev.tolist() == [0, 1, 2, 3]
    dev, meta = stager.take()
    assert meta is None and dev.numel() == 6


def test_reads_interleave_with_ingestion(tmp_path):
    """Readers polling mid-stream observe monotonically growing (version, n)
    pairs, each a real prefix position."""
    rt = _runtime()
    with ServingTier(_config(rt, tmp_path, publish_every=1, ring_depth=4),
                     runtime=rt) as tier:
        seen = []
        for b in _blocks(6):
            tier.submit(b)
            top = tier.frontend.top_table(2)
            seen.append((top.version, top.n))
        snap = tier.drain()
        versions = [v for v, _ in seen]
        ns = [n for _, n in seen]
        assert versions == sorted(versions) and ns == sorted(ns)
        assert tier.frontend.top_table(1).version == snap.version
        block_n = rt.workers * CHUNK
        for i, n in enumerate(ns):
            assert n % block_n == 0 and n <= (i + 1) * block_n


def test_publisher_state_survives_in_place_writes():
    """An eager publish, then an ingest that writes the same buffer in
    place: the published snapshot keeps its position."""
    rt = _runtime()
    blocks = _blocks(3, seed=30)
    state = rt.ingest(rt.init(), host_blocks(blocks[0], rt.workers, CHUNK))
    ring = SnapshotRing(depth=2)
    pub = RingPublisher(rt, ring)
    eager = pub.publish(state)
    lazy = pub.publish(state, lazy=True, n_hint=int(state.n.sum()))
    state = SketchState(state.summary, state.buffer, state.fill, state.n)
    for b in blocks[1:]:
        state = rt.ingest(state, host_blocks(b, rt.workers, CHUNK))
    ref = _sync_snapshot(rt, blocks[:1])
    _summaries_equal(ref, eager)
    _summaries_equal(ref, lazy)
