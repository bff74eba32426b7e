"""repro_torch engine + service against repro's: the same inputs, the same bits.

Both packages start from the same state (``state_from_numpy`` takes the
JAX SketchState's leaves) and see the same stream; every state, merged
summary, snapshot and frontend answer is compared exactly. The JAX side
uses ``kernel="jnp"``/``"sorted"``, the port runs on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro.service import QueryFrontend as JFrontend
from repro_torch.engine import (EngineConfig, SketchEngine, state_from_numpy,
                                state_to_numpy)
from repro_torch.service import QueryFrontend

# one intra-op thread per test process: the suite runs in parallel
# workers, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

GEOM = dict(k=64, tenants=3, chunk=32)
_engines = {}


def engines(depth, flush_mode="deferred", jkernel="jnp", tkernel="torch", **geom):
    """A (JAX engine, port engine) pair of one geometry, cached across tests."""
    geom = {**GEOM, **geom}
    key = (depth, flush_mode, jkernel, tkernel, tuple(sorted(geom.items())))
    if key not in _engines:
        _engines[key] = (
            JEngine(JConfig(buffer_depth=depth, flush_mode=flush_mode,
                            kernel=jkernel, **geom)),
            SketchEngine(EngineConfig(buffer_depth=depth, flush_mode=flush_mode,
                                      kernel=tkernel, device="cpu", **geom)))
    return _engines[key]


def zipf(rng, shape, cap=400):
    return np.minimum(rng.zipf(1.3, shape), cap).astype(np.int32)


def jleaves(state):
    return [np.asarray(a) for a in jax.tree.leaves(state)]


def assert_state(jstate, tstate):
    for a, b in zip(jleaves(jstate), state_to_numpy(tstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def assert_summary(js, ts):
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def to_port(jstate):
    return state_from_numpy(*jleaves(jstate), device="cpu")


@pytest.mark.parametrize("flush_mode", ["deferred", "replay"])
@pytest.mark.parametrize("depth,n_chunks", [(2, 5), (3, 9)])
def test_ingest_bitwise(rng, flush_mode, depth, n_chunks):
    """ingest from empty, then from a mid-stream state (fill > 0)."""
    je, te = engines(depth, flush_mode)
    stream = zipf(rng, (3, n_chunks * 32 - 7))             # a ragged last chunk
    js = je.ingest(je.init(), stream)
    ts = te.ingest(te.init(), stream)
    assert_state(js, ts)
    assert ts.fill == n_chunks % depth
    more = zipf(rng, (3, 50))
    ts2 = te.ingest(to_port(js), more)
    assert_state(je.ingest(js, more), ts2)


def test_update_flush_and_absorb_bitwise(rng):
    je, te = engines(3)
    js, ts = je.init(), te.init()
    for i in range(7):
        chunk = zipf(rng, (3, 32 if i % 2 else 20))      # short chunks are padded
        js, ts = je.update(js, chunk), te.update(ts, chunk)
        assert_state(js, ts)
    js, ts = je.flush(js), te.flush(ts)
    assert_state(js, ts)
    items = np.unique(zipf(rng, 40))[:16].astype(np.int32)
    weights = rng.integers(0, 5, items.shape).astype(np.int32)
    assert_state(je.absorb_histogram(js, items, weights),
                 te.absorb_histogram(ts, items, weights))
    with pytest.raises(ValueError):
        te.update(ts, np.zeros((3, 33), np.int32))


@pytest.mark.parametrize("jkernel,tkernel", [("jnp", "torch"), ("sorted", "sorted")])
def test_merged_top_estimate_bitwise(rng, jkernel, tkernel):
    je, te = engines(2, jkernel=jkernel, tkernel=tkernel)
    js = je.ingest(je.init(), zipf(rng, (3, 4 * 32)))       # fill == 0
    assert int(js.fill) == 0
    for state in (js, je.ingest(js, zipf(rng, (3, 32)))):  # then fill == 1
        ts = to_port(state)
        assert_summary(je.merged(state), te.merged(ts))
        q = np.concatenate([np.asarray(je.merged(state).items)[:20],
                            rng.integers(-1, 500, 20)]).astype(np.int32)
        for a, b in zip(je.estimate(state, q), te.estimate(ts, q)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for n in (0, 5, 64, 100):
            for a, b in zip(je.top(state, n), te.top(ts, n)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_merged_at_full_width_bitwise(rng):
    """k = 2048, 4 tenants, sorted matchers on both sides."""
    je, te = engines(2, jkernel="sorted", tkernel="sorted", k=2048, tenants=4, chunk=256)
    stream = rng.integers(0, 6000, (4, 3 * 256)).astype(np.int32)
    js = je.ingest(je.init(), stream)
    ts = te.ingest(te.init(), stream)
    assert_state(js, ts)
    assert_summary(je.merged(js), te.merged(ts))


def test_snapshot_eager_and_lazy(rng):
    je, te = engines(3)
    js = je.ingest(je.init(), zipf(rng, (3, 5 * 32)))       # fill == 2
    ts = to_port(js)
    jsnap, tsnap = je.snapshot(js), te.snapshot(ts)
    assert_summary(jsnap.summary, tsnap.summary)
    assert int(jsnap.n) == int(tsnap.n) and tsnap.tenants == 3
    jd, td = jsnap.describe(), tsnap.describe()
    assert {**jd, "kernel": None, "version": None} == {**td, "kernel": None, "version": None}
    lazy = te.snapshot(ts, lazy=True, n_hint=int(ts.n.sum()))
    assert not lazy.materialized and lazy.version == tsnap.version + 1
    assert lazy.count_floor == int(ts.n.sum()) // 64
    ts = te.ingest(ts, zipf(rng, (3, 4 * 32)))             # writes the buffer in place
    assert lazy.materialized is False
    for a, b in zip(lazy.summary, tsnap.summary):
        assert torch.equal(a, b)
    assert lazy.materialized and int(lazy.n) == int(tsnap.n)
    assert lazy.describe()["occupancy"] == td["occupancy"]
    after = te.snapshot(ts)
    assert int(after.n) > int(tsnap.n)


def test_frontend_bitwise(rng):
    je, te = engines(2)
    js = je.ingest(je.init(), zipf(rng, (3, 6 * 32 + 5)))
    jsnap, tsnap = je.snapshot(js), te.snapshot(to_port(js))
    jf, tf = JFrontend("jnp"), QueryFrontend("torch")
    q = np.concatenate([np.asarray(jsnap.summary.items)[:10],
                        rng.integers(-1, 500, 9)]).astype(np.int32)
    for a, b in zip(jf.estimate(jsnap, q), tf.estimate(tsnap, q)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    sets = [q[:3], q[3:], q[:1]]
    for ja, ta in zip(jf.estimate_many(jsnap, sets), tf.estimate_many(tsnap, sets)):
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jf.top(jsnap, 12), tf.top(tsnap, 12)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jf.top_table(jsnap, 80) == tf.top_table(tsnap, 80)
    for a, b in zip(jf.threshold(jsnap, 3), tf.threshold(tsnap, 3)):
        np.testing.assert_array_equal(a, b)
    for k_maj in (1, 16, 64, 200):
        jr, tr = jf.k_majority_report(jsnap, k_maj), tf.k_majority_report(tsnap, k_maj)
        assert jr.describe() == tr.describe()
        for field in ("guaranteed_items", "guaranteed_counts", "guaranteed_lower",
                      "unconfirmed_items", "unconfirmed_counts", "unconfirmed_lower"):
            np.testing.assert_array_equal(getattr(jr, field), getattr(tr, field))
    assert tf._bucket(17, "cpu") == 32 and tf._bucket(1, "cpu") == 16
    with pytest.raises(ValueError):
        tf.k_majority_report(tsnap, 0)


def test_int64_engine_equals_int32():
    """Within the port: int64 counts give the int32 values on a short stream."""
    rng = np.random.default_rng(5)
    stream = zipf(rng, (2, 300))
    out = []
    for dtype in ("int32", "int64"):
        e = SketchEngine(EngineConfig(k=64, tenants=2, chunk=32, buffer_depth=2,
                                      count_dtype=dtype, device="cpu"))
        s = e.ingest(e.init(), stream)
        assert s.counts.dtype == getattr(torch, dtype)
        out.append((e.merged(s), e.snapshot(s)))
    (m32, s32), (m64, s64) = out
    for a, b in zip(m32, m64):
        assert torch.equal(a.long(), b.long())
    assert int(s32.n) == int(s64.n) == 600


def test_config_validation_and_state_roundtrip():
    fused = EngineConfig(kernel="fused", device="cpu")
    assert fused.resolved_kernel() == fused.resolved_flush_kernel() == "fused"
    assert fused.pair_fn() is not None and fused.window_fn() is not None
    assert EngineConfig(device="cpu").pair_fn() is None
    with pytest.raises(ValueError):
        EngineConfig(kernel="cuda", device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(kernel="pallas", device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(count_dtype="float32", device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(reduction="butterfly", device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(buffer_depth=0, device="cpu")
    cfg = EngineConfig(device="cpu")
    assert (cfg.k, cfg.chunk, cfg.buffer_depth, cfg.resolved_kernel()) == (2048, 2048, 8, "sorted")
    assert EngineConfig().device == "cuda"
    _, te = engines(2)
    st = te.ingest(te.init(), np.arange(3 * 40, dtype=np.int32).reshape(3, 40))
    back = state_from_numpy(*state_to_numpy(st), device="cpu")
    for a, b in zip(state_to_numpy(st), state_to_numpy(back)):
        np.testing.assert_array_equal(a, b)
    assert back.fill == st.fill == 0 and back.k == 64 and back.depth == 2
