"""repro_torch.runtime against repro.runtime, one process (shards = 1).

The port's counterparts of ``tests/test_runtime.py``, on numpy streams from
a seed, with tolerance 0: the single-shard runtime equals the JAX
``StreamRuntime(shards=1)`` (states, summaries, ``n``, ``shard_n``,
versions), every strategy degrades to ``local`` on one shard, ``feed``
equals sequential ``ingest`` and leaves the caller's state as it was, the
host decompositions equal the JAX package's arrays, and the one-shot API
equals ``repro``'s at p ∈ {1, 4, 8}. The port runs on the CPU with impls
``torch`` and ``sorted`` (the JAX ``jnp`` and ``sorted``). The runs at
p > 1 over torch.distributed are in ``tests/test_torch_distributed.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro_torch.core import local_summaries, parallel_spacesaving as core_pss
from repro_torch.core.combine import reduce_summaries
from repro_torch.core.parallel import block_decompose
from repro_torch.engine import EngineConfig, SketchEngine, state_to_numpy
from repro_torch.runtime import (DeviceFeed, RuntimeConfig, StreamRuntime,
                                 coalesce_blocks, frequent_items, host_block_iter,
                                 host_blocks, parallel_spacesaving)

torch.set_num_threads(1)

K, LANES, CHUNK, DEPTH = 128, 4, 256, 4
IMPLS = [("jnp", "torch"), ("sorted", "sorted")]


def _runtime(lanes=LANES, kernel="torch", shards=1, **kw):
    eng = EngineConfig(k=K, tenants=lanes, chunk=CHUNK, buffer_depth=DEPTH,
                       kernel=kernel, device="cpu")
    return StreamRuntime(RuntimeConfig(engine=eng, shards=shards, **kw))


def _jruntime(kernel="jnp", **kw):
    eng = JConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH, kernel=kernel)
    return jrt.StreamRuntime(jrt.RuntimeConfig(engine=eng, shards=1, **kw))


def _stream(n=20_000, seed=0):
    return zipf_stream(n, 1.2, seed=seed, max_id=10**5)


def _states_equal(a, b):
    """Port states, or a JAX state (first) against a port state."""
    left = ([np.asarray(x) for x in jax.tree.leaves(a)] if not hasattr(a.buffer, "numpy")
            else state_to_numpy(a))
    for name, x, y in zip(("items", "counts", "errors", "buffer", "fill", "n"),
                          left, state_to_numpy(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)


def _summaries_equal(a, b):
    for name, x, y in zip(("items", "counts", "errors"), a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


# ---------------------------------------------------------------------------
# Config / topology validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(shards=0), "shards"), (dict(pods=0), "pods"),
    (dict(shards=4, pods=3), "divide"), (dict(feed_depth=0), "feed_depth"),
    (dict(reduction="nope"), "not registered")])
def test_runtime_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        RuntimeConfig(engine=EngineConfig(k=K, tenants=LANES, device="cpu"), **kw)


def test_topology_errors_without_a_process_group():
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError, match="requested 2 ranks but only 1 rank"):
        make_host_mesh(n_data=2, device_type="cpu")
    with pytest.raises(ValueError, match="requested 2 shards but only 1 rank"):
        _runtime(shards=2)
    with pytest.raises(ValueError, match="requested 4 shards but only 1 rank"):
        _runtime(shards=4, pods=2)
    # mesh dimensions need a mesh: an engine alone has none
    cfg = EngineConfig(k=K, tenants=LANES, device="cpu", axis_names=("data",))
    assert hash(cfg) == hash(EngineConfig(k=K, tenants=LANES, device="cpu",
                                          axis_names=("data",)))
    with pytest.raises(ValueError, match="do not exist"):
        SketchEngine(cfg)


def test_shards_default_to_one_without_a_process_group():
    rt = StreamRuntime(RuntimeConfig(engine=EngineConfig(k=K, tenants=LANES,
                                                         device="cpu")))
    assert (rt.shards, rt.workers, rt.mesh, rt.rows) == (1, LANES, None, slice(0, LANES))


# ---------------------------------------------------------------------------
# Single-shard runtime == the JAX runtime (bitwise, pending buffers included)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jimpl,impl", IMPLS)
def test_single_shard_runtime_matches_repro(jimpl, impl):
    rt, jr = _runtime(kernel=impl), _jruntime(kernel=jimpl)
    stream = _stream(19_000)            # 19 chunks a lane: fill 3 pending chunks
    st, jst = rt.ingest(rt.init(), stream), jr.ingest(jr.init(), jnp.asarray(stream))
    _states_equal(jst, st)
    assert st.fill == 3
    for _ in range(2):
        snap, jsnap = rt.snapshot(st), jr.snapshot(jst)
        _summaries_equal(jsnap.summary, snap.summary)
        assert int(snap.n) == int(jsnap.n) == stream.size
        np.testing.assert_array_equal(np.asarray(jsnap.shard_n), snap.shard_n.numpy())
        assert (snap.version, snap.tenants, snap.kernel) == \
            (jsnap.version, jsnap.tenants, impl)
    lazy = rt.snapshot(st, lazy=True)
    _summaries_equal(jr.merged(jst), lazy.summary)
    assert lazy.version == 3
    # reads never flush; the engine of the runtime is the bare engine
    assert st.fill == 3
    eng = SketchEngine(EngineConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH,
                                    kernel=impl, device="cpu"))
    _states_equal(st, eng.ingest(eng.init(), block_decompose(stream, LANES, CHUNK)))


@pytest.mark.parametrize("strategy", ["butterfly", "allgather", "hierarchical", "auto"])
def test_reduction_strategies_degrade_to_local_on_one_shard(strategy):
    stream = _stream()
    base, rt = _runtime(reduction="local"), _runtime(reduction=strategy)
    assert rt.engine.config.reduction == ("local" if strategy == "auto" else strategy)
    m1 = base.merged(base.ingest(base.init(), stream))
    m2 = rt.merged(rt.ingest(rt.init(), stream))
    _summaries_equal(m1, m2)
    jr = _jruntime(reduction=strategy)
    _summaries_equal(jr.merged(jr.ingest(jr.init(), jnp.asarray(stream))), m2)


# ---------------------------------------------------------------------------
# Feed path == plain ingestion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
def test_feed_matches_sequential_ingest_and_repro(depth):
    rt = _runtime(feed_depth=depth)
    blocks = [zipf_stream(rt.workers * CHUNK * 3, 1.1, seed=i, max_id=10**5)
              for i in range(5)]
    fed = rt.feed(rt.init(), iter(blocks))
    seq = rt.init()
    for b in blocks:
        seq = rt.ingest(seq, b)
    _states_equal(fed, seq)
    jr = _jruntime(feed_depth=depth)
    _states_equal(jr.feed(jr.init(), iter(blocks)), fed)


def test_feed_leaves_the_callers_state_unchanged():
    rt = _runtime()
    st0 = rt.ingest(rt.init(), _stream(3 * LANES * CHUNK))       # fill 3, mid-window
    before = state_to_numpy(st0)
    blocks = [zipf_stream(rt.workers * CHUNK, 1.1, seed=i, max_id=10**5)
              for i in range(3)]
    fed = rt.feed(st0, iter(blocks))                             # flushes in place
    for name, x, y in zip(("items", "counts", "errors", "buffer", "fill", "n"),
                          before, state_to_numpy(st0)):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert int(fed.n.sum()) == int(st0.n.sum()) + sum(len(b) for b in blocks)


def test_feed_final_partial_block_not_truncated():
    rt = _runtime()
    sizes = [rt.workers * CHUNK, rt.workers * CHUNK // 2 + 7]
    blocks = [zipf_stream(s, 1.1, seed=i, max_id=10**5) for i, s in enumerate(sizes)]
    fed = rt.feed(rt.init(), iter(blocks))
    assert int(fed.n.sum()) == sum(sizes)
    seq = rt.init()
    for b in blocks:
        seq = rt.ingest(seq, host_blocks(b, rt.workers, CHUNK))
    _states_equal(fed, seq)


def test_device_feed_preserves_order_and_depth():
    with pytest.raises(ValueError, match="depth"):
        DeviceFeed([], device="cpu", depth=0)
    blocks = [np.full((4,), i, np.int32) for i in range(7)]
    out = list(DeviceFeed(iter(blocks), device="cpu", depth=3))
    assert len(out) == 7
    for i, b in enumerate(out):
        np.testing.assert_array_equal(b.numpy(), blocks[i])


# ---------------------------------------------------------------------------
# Host decompositions == repro's arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,workers,multiple", [(10_000, 8, CHUNK), (10, 4, 8), (0, 3, 16),
                                                 (4096, 4, 256)])
def test_host_blocks_match_repro(n, workers, multiple):
    stream = zipf_stream(n, 1.3, seed=3, max_id=10**4)
    hb = host_blocks(stream, workers, multiple)
    np.testing.assert_array_equal(hb, jrt.host_blocks(stream, workers, multiple))
    np.testing.assert_array_equal(hb, block_decompose(stream, workers, multiple).numpy())


@pytest.mark.parametrize("n_pieces", [1, 7, 23])
@pytest.mark.parametrize("block_items", [None, 4 * 32 * 2, 1000])
def test_host_block_iter_matches_repro(n_pieces, block_items):
    stream = zipf_stream(10_000, 1.3, seed=5, max_id=10**4)
    pieces = np.array_split(stream, n_pieces)
    got = list(host_block_iter(pieces, 4, 32, block_items=block_items))
    want = list(jrt.host_block_iter(pieces, 4, 32, block_items=block_items))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_coalesce_blocks_matches_repro():
    from repro.runtime.feed import coalesce_blocks as jcoalesce
    payloads = [zipf_stream(n, 1.2, seed=n, max_id=10**4) for n in (100, 1, 513)]
    for k in (1, 3):
        np.testing.assert_array_equal(coalesce_blocks(payloads[:k], 4, 32),
                                      jcoalesce(payloads[:k], 4, 32))


def test_ingest_rejects_off_chunk_blocks():
    rt = _runtime()
    with pytest.raises(ValueError, match="multiple of the engine chunk"):
        rt.ingest(rt.init(), np.ones((rt.workers, CHUNK + 1), np.int32))
    with pytest.raises(ValueError, match="worker blocks"):
        rt.ingest(rt.init(), torch.ones((rt.workers + 1, CHUNK), dtype=torch.int32))


def test_empty_stream_is_noop():
    rt = _runtime()
    state0 = rt.init()
    _states_equal(rt.ingest(state0, np.zeros((0,), np.int32)), state0)
    _states_equal(rt.ingest(state0, rt.decompose(torch.zeros((0,), dtype=torch.int32))),
                  state0)
    _states_equal(rt.feed(state0, [np.zeros((0,), np.int32)]), state0)
    assert tuple(rt.decompose(np.zeros((0,), np.int32)).shape) == (rt.workers, 0)
    assert int(rt.snapshot(rt.feed(state0, iter([]))).n) == 0


# ---------------------------------------------------------------------------
# One-shot API (Algorithm 1) == repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jimpl,impl", IMPLS)
@pytest.mark.parametrize("p", [1, 4, 8])
def test_oneshot_matches_repro(p, jimpl, impl):
    stream = _stream(40_000, seed=7)
    got = parallel_spacesaving(stream, k=K, p=p, chunk_size=CHUNK, kernel=impl,
                               device="cpu")
    want = jrt.parallel_spacesaving(jnp.asarray(stream), k=K, p=p, chunk_size=CHUNK,
                                    kernel=jimpl)
    _summaries_equal(want, got)
    # the classical composition: local summaries, then ParallelReduction
    _summaries_equal(got, reduce_summaries(local_summaries(stream, p=p, k=K,
                                                           chunk_size=CHUNK, device="cpu")))
    jf = jrt.frequent_items(jnp.asarray(stream), k_majority=50, counters=K, p=p,
                            chunk_size=CHUNK)
    tf = frequent_items(stream, k_majority=50, counters=K, p=p, chunk_size=CHUNK,
                        device="cpu")
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_core_reexports_are_runtime_backed():
    stream = _stream(8_000, seed=9)
    a = core_pss(stream, k=64, p=2, chunk_size=CHUNK, device="cpu")
    b = parallel_spacesaving(stream, k=64, p=2, chunk_size=CHUNK, device="cpu")
    _summaries_equal(a, b)


def test_frontend_takes_the_runtime_kernel():
    rt = _runtime(kernel="sorted")
    st = rt.ingest(rt.init(), _stream(9_000))
    fe = rt.frontend()
    assert fe.kernel == "sorted"
    f_hat, lower, _ = fe.estimate(rt.snapshot(st), np.array([1, 2, 3], np.int32))
    assert (lower <= f_hat).all()
