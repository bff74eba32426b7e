"""repro_torch.checkpoint against repro.checkpoint, on the CPU.

The port's counterparts of ``tests/test_checkpoint.py`` (round trip,
incomplete checkpoints, retention, structure mismatch, a SketchState
mid-stream), and the two directions across packages: a checkpoint the JAX
package writes restores in the port, and one the port writes restores in
the JAX package, leaf for leaf and with the same paths. The JAX side runs
``kernel="jnp"``/``"sorted"``, the port ``"torch"``/``"sorted"``; every
comparison is bitwise (tolerance 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCKPT
from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro_torch.checkpoint import manager as CKPT
from repro_torch.core.combine import reduce_summaries
from repro_torch.core.exact import overestimation_violations
from repro_torch.engine import (EngineConfig, SketchEngine, state_from_numpy,
                                state_to_numpy)

torch.set_num_threads(1)

IMPLS = [("jnp", "torch"), ("sorted", "sorted")]


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.randn(8, generator=g).to(torch.bfloat16)},
            "count": torch.tensor(7, dtype=torch.int32),
            "steps": [torch.arange(3), (torch.ones(2, dtype=torch.float64), 5)]}


def _engines(jk, tk, k=64, tenants=4, chunk=256, depth=4):
    return (JEngine(JConfig(k=k, tenants=tenants, chunk=chunk, buffer_depth=depth,
                            kernel=jk)),
            SketchEngine(EngineConfig(k=k, tenants=tenants, chunk=chunk,
                                      buffer_depth=depth, kernel=tk, device="cpu")))


def _stream(tenants, n, seed=0, skew=1.2):
    return zipf_stream(tenants * n, skew, seed=seed, max_id=10**5).reshape(tenants, n)


def _assert_tree_equal(a, b):
    pa, la, _ = CKPT._flatten(a)
    pb, lb, _ = CKPT._flatten(b)
    assert pa == pb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def _jax_equal_port(jstate, tstate):
    for name, x, y in zip(("items", "counts", "errors", "buffer", "fill", "n"),
                          [np.asarray(v) for v in jax.tree.leaves(jstate)],
                          state_to_numpy(tstate)):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_flatten_paths_match_keystr():
    """Leaf order and path strings are jax.tree_util's (dict keys sorted)."""
    tree = _tree(0)
    jtree = jax.tree.map(lambda t: np.asarray(t.float()) if isinstance(t, torch.Tensor)
                         else t, tree)
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    paths, leaves, rebuild = CKPT._flatten(tree)
    assert paths == want
    _assert_tree_equal(rebuild(leaves), tree)
    jeng, teng = _engines("jnp", "torch")
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jeng.init())[0]]
    assert CKPT._flatten(teng.init())[0] == jpaths == [
        ".summary.items", ".summary.counts", ".summary.errors", ".buffer", ".fill", ".n"]


def test_roundtrip_exact(tmp_path):
    st = _tree(1)
    CKPT.save(tmp_path, 5, st, {"seed": 1, "step": 5})
    assert CKPT.latest_step(tmp_path) == 5
    restored, dstate = CKPT.restore(tmp_path, 5, _tree(2))
    _assert_tree_equal(restored, st)
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert dstate == {"seed": 1, "step": 5}


def test_incomplete_checkpoint_ignored(tmp_path):
    st = _tree(3)
    CKPT.save(tmp_path, 3, st)
    d = CKPT.save(tmp_path, 9, st)
    (d / "_COMPLETE").unlink()            # simulate crash mid-publish
    assert CKPT.latest_step(tmp_path) == 3
    with pytest.raises(AssertionError, match="incomplete"):
        CKPT.restore(tmp_path, 9, st)


@pytest.mark.parametrize("keep,want", [(2, [4, 5]), (3, [3, 4, 5]), (1, [5])])
def test_retention(tmp_path, keep, want):
    st = _tree(4)
    for s in [1, 2, 3, 4, 5]:
        CKPT.save(tmp_path, s, st, keep=keep)
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.glob("step_*"))
    assert steps == want


def test_structure_mismatch_rejected(tmp_path):
    st = _tree(5)
    CKPT.save(tmp_path, 1, st)
    other = {"params": {"w": st["params"]["w"]}, "count": st["count"],
             "steps": st["steps"]}
    with pytest.raises(AssertionError, match="structure"):
        CKPT.restore(tmp_path, 1, other)
    wrong = _tree(5)
    wrong["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="params"):
        CKPT.restore(tmp_path, 1, wrong)


@pytest.mark.parametrize("jk,tk", IMPLS)
def test_sketch_state_mid_stream_restores_bitwise(tmp_path, jk, tk):
    """fill > 0 survives the trip; the restored state snapshots and keeps
    ingesting exactly like the original."""
    _, eng = _engines(jk, tk)
    stream = _stream(4, 7_500)
    state = eng.ingest(eng.init(), torch.from_numpy(stream))
    assert state.fill > 0
    before = state_to_numpy(state)
    CKPT.save(tmp_path, 7, state, {"step": 7})
    restored, _ = CKPT.restore(tmp_path, 7, eng.init())
    assert isinstance(restored.fill, int) and restored.fill == state.fill
    for a, b in zip(before, state_to_numpy(restored)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(eng.snapshot(state).summary, eng.snapshot(restored).summary):
        assert torch.equal(a, b)
    more = torch.from_numpy(_stream(4, 2048, seed=1))
    for a, b in zip(state_to_numpy(eng.ingest(state, more)),
                    state_to_numpy(eng.ingest(restored, more.clone()))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("jk,tk", IMPLS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, jk, tk):
    """JAX saves a mid-stream SketchState; the port restores it and both
    packages ingest on to the same bits."""
    jeng, teng = _engines(jk, tk)
    stream, more = _stream(4, 7_500), _stream(4, 3_000, seed=2)
    jstate = jeng.ingest(jeng.init(), jnp.asarray(stream))
    assert int(jstate.fill) > 0
    JCKPT.save(tmp_path, 3, jstate, {"cursor": 7_500})
    restored, dstate = CKPT.restore(tmp_path, 3, teng.init())
    assert dstate == {"cursor": 7_500}
    _jax_equal_port(jstate, restored)
    _jax_equal_port(jeng.ingest(jstate, jnp.asarray(more)),
                    teng.ingest(restored, torch.from_numpy(more)))


@pytest.mark.parametrize("jk,tk", IMPLS)
def test_port_checkpoint_restores_in_jax(tmp_path, jk, tk):
    jeng, teng = _engines(jk, tk)
    stream, more = _stream(4, 7_500, seed=3), _stream(4, 3_000, seed=4)
    tstate = teng.ingest(teng.init(), torch.from_numpy(stream))
    assert tstate.fill > 0
    CKPT.save(tmp_path, 4, tstate, {"cursor": 7_500})
    jstate, dstate = JCKPT.restore(tmp_path, 4, jeng.init())
    assert dstate == {"cursor": 7_500}
    assert jstate.fill.dtype == jnp.int32
    _jax_equal_port(jstate, tstate)
    _jax_equal_port(jeng.ingest(jstate, jnp.asarray(more)),
                    teng.ingest(tstate, torch.from_numpy(more)))


def test_trees_cross_packages(tmp_path):
    """A tree of float32, bfloat16 and int32 leaves, both directions."""
    g = np.random.default_rng(0)
    w = g.standard_normal((8, 8)).astype(np.float32)
    b = g.standard_normal(8).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)},
             "count": jnp.int32(7)}
    ttree = {"params": {"w": torch.from_numpy(w),
                        "b": torch.from_numpy(b).to(torch.bfloat16)},
             "count": torch.tensor(7, dtype=torch.int32)}
    JCKPT.save(tmp_path / "jax", 1, jtree)
    got, _ = CKPT.restore(tmp_path / "jax", 1, ttree)
    _assert_tree_equal(got, ttree)
    CKPT.save(tmp_path / "port", 1, ttree)
    back, _ = JCKPT.restore(tmp_path / "port", 1, jtree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


@pytest.mark.parametrize("jk,tk", IMPLS)
@pytest.mark.parametrize("new_groups", [2, 4, 16])
def test_reshard_equals_jax_and_preserves_bounds(jk, tk, new_groups):
    jeng, teng = _engines(jk, tk, tenants=8, chunk=512, depth=2)
    stream = _stream(8, 2_500, seed=5)
    jsk = jeng.ingest(jeng.init(), jnp.asarray(stream))
    tsk = teng.ingest(teng.init(), torch.from_numpy(stream))
    assert tsk.fill > 0                  # reshard must flush the pending buffer
    cfg = teng.config
    jres = JCKPT.reshard_token_sketch(jsk, new_groups,
                                      match_fn=jeng.config.match_fn())
    tres = CKPT.reshard_token_sketch(tsk, new_groups, match_fn=cfg.match_fn(),
                                     window_fn=cfg.window_fn(), pair_fn=cfg.pair_fn())
    _jax_equal_port(jres, tres)
    assert tres.items.shape == (new_groups, 64)
    assert tres.buffer.shape == (new_groups, 2, 512)
    assert int(tres.n.sum()) == stream.size
    merged = reduce_summaries(tres.summary)
    assert overestimation_violations(merged, torch.from_numpy(stream.reshape(-1))) == 0


def test_reshard_replay_mode_equals_jax():
    jeng, teng = _engines("jnp", "torch", tenants=4, chunk=256, depth=4)
    stream = _stream(4, 1_700, seed=6)
    jsk = jeng.ingest(jeng.init(), jnp.asarray(stream))
    tsk = teng.ingest(teng.init(), torch.from_numpy(stream))
    _jax_equal_port(JCKPT.reshard_token_sketch(jsk, 2, flush_mode="replay"),
                    CKPT.reshard_token_sketch(tsk, 2, flush_mode="replay"))


def test_restore_moves_leaves_to_the_device(tmp_path):
    _, eng = _engines("jnp", "torch")
    state = eng.ingest(eng.init(), torch.from_numpy(_stream(4, 1_000)))
    CKPT.save(tmp_path, 1, state)
    restored, _ = CKPT.restore(tmp_path, 1, eng.init(), device="cpu")
    assert all(t.device.type == "cpu" for t in (*restored.summary, restored.buffer,
                                                 restored.n))
    st2 = state_from_numpy(*state_to_numpy(restored), device="cpu")
    for a, b in zip(state_to_numpy(st2), state_to_numpy(state)):
        np.testing.assert_array_equal(a, b)
