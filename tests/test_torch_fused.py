"""The port's fused path (``impl="fused"``) against repro on the CPU.

On a CPU tensor the ``ss_ingest`` wrappers compute their plain version, so
``ops.ingest_window``/``ops.combine_summaries`` with ``impl="fused"`` and a
``kernel="fused"`` engine run here end to end. Every result is held bit for
bit (integer sums: tolerance 0) against the JAX package's sorted window ops
and engine on the same numpy inputs, and at one tiny shape against the
Pallas megakernels themselves in interpret mode. The CUDA kernels run only
on a card (``tests/test_torch_gpu.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels.ss_ingest import fused_combine_pallas, fused_ingest_pallas
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.kernels import ops, ref, ss_ingest
from repro_torch.service import QueryFrontend

# one intra-op thread per test process: the suite runs in parallel
# workers, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

# clusters of 2, 4, 8 and 16 blocks an NVIDIA H100 80GB HBM3 runs at once
# (cudaOccupancyMaxActiveClusters of both cluster kernels at every size, one
# 1 024-thread block an SM; chip_smoke.py's cluster_path line): the routing
# rule's input on that card, which the wrappers query from the card itself
H100_AT_ONCE = {2: 66, 4: 30, 8: 15, 16: 7}


def summaries(rng, b, k, fill, *, count_hi=1000, id_range=None):
    """(B, k) summaries: distinct ids in a random ``fill`` share of the slots."""
    id_range = id_range or 8 * k
    n = int(k * fill)
    items = np.full((b, k), -1, np.int32)
    counts = np.zeros((b, k), np.int32)
    for i in range(b):
        slots = rng.permutation(k)[:n]
        items[i, slots] = rng.choice(id_range, n, replace=False)
        counts[i, slots] = rng.integers(1, count_hi, n)
    return items, counts, counts // 4


def zipf_window(rng, b, w, id_range):
    """Zipf ids with about one EMPTY in ten (stream padding)."""
    win = np.minimum(rng.zipf(1.2, (b, w)), id_range - 1).astype(np.int32)
    win[rng.random((b, w)) < 0.1] = -1
    return win


def port(arrays, dtype=np.int32):
    """numpy → torch; counts and errors (every array after the first) in ``dtype``."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.int32 if i == 0 else dtype))
                 for i, a in enumerate(arrays))


def assert_same(jout, tout, dtype=torch.int32):
    """JAX's int32 result equals the port's, whose counts are in ``dtype``."""
    assert len(jout) == len(tout) == 3
    for i, (a, b) in enumerate(zip(jout, tout)):
        assert b.dtype == (torch.int32 if i == 0 else dtype)
        np.testing.assert_array_equal(np.asarray(a).astype(b.numpy().dtype), b.numpy())


# jitted: one XLA compile per shape instead of one per op of the merge
_jax_ingest = jax.jit(functools.partial(jops.ingest_window, impl="sorted"))
_jax_combine = jax.jit(functools.partial(jops.combine_summaries, impl="sorted"))


def jax_ingest(items, counts, errors, window):
    return _jax_ingest(*(jnp.asarray(a) for a in (items, counts, errors, window)))


def jax_combine(s1, s2):
    return _jax_combine(*(jnp.asarray(a) for a in (*s1, *s2)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fill", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("b,k,w", [(1, 64, 32), (3, 128, 256), (2, 300, 100)])
def test_fused_ingest_equals_jax(rng, b, k, w, fill, dtype):
    """The fused flush vs JAX's sorted flush; W < k and a full summary included."""
    s = summaries(rng, b, k, fill)
    win = zipf_window(rng, b, w, 8 * k)
    before = ss_ingest.INGEST_LAUNCHES
    got = ops.ingest_window(*port(s, dtype), torch.from_numpy(win), impl="fused")
    assert ss_ingest.INGEST_LAUNCHES == before     # a CPU tensor launches nothing
    assert_same(jax_ingest(*s, win), got, getattr(torch, np.dtype(dtype).name))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_fused_ingest_all_empty_window(rng, dtype):
    s = summaries(rng, 3, 128, 0.5)
    win = np.full((3, 256), -1, np.int32)
    got = ss_ingest.fused_ingest(*port(s, dtype), torch.from_numpy(win))
    assert_same(jax_ingest(*s, win), got, getattr(torch, np.dtype(dtype).name))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fills", [(1.0, 0.3), (0.6, 1.0), (0.0, 0.6), (1.0, 1.0)])
@pytest.mark.parametrize("b,k", [(1, 64), (3, 128), (4, 256), (2, 300)])
def test_fused_combine_equals_jax(rng, b, k, fills, dtype):
    """The fused COMBINE vs JAX's sorted COMBINE; ids overlap between the two."""
    s1 = summaries(rng, b, k, fills[0], id_range=2 * k)
    s2 = summaries(rng, b, k, fills[1], id_range=2 * k)
    before = ss_ingest.COMBINE_LAUNCHES
    got = ops.combine_summaries(*port(s1, dtype), *port(s2, dtype), impl="fused")
    assert ss_ingest.COMBINE_LAUNCHES == before
    assert_same(jax_combine(s1, s2), got, getattr(torch, np.dtype(dtype).name))


def test_fused_tie_heavy_equals_jax(rng):
    """Many equal counts and weights: the pool order alone decides the winners."""
    k, w = 128, 256
    s = summaries(rng, 3, k, 1.0, count_hi=4, id_range=200)
    # each window id appears exactly 3 times: candidates tie at 3 + m₁
    ids = rng.permutation(200)[:w // 3].astype(np.int32)
    win = np.full((3, w), -1, np.int32)
    for i in range(3):
        win[i, :len(ids) * 3] = rng.permutation(np.repeat(ids, 3))
    assert_same(jax_ingest(*s, win), ss_ingest.fused_ingest(*port(s), torch.from_numpy(win)))
    s2 = summaries(rng, 3, k, 0.7, count_hi=4, id_range=200)
    assert_same(jax_combine(s, s2), ss_ingest.fused_combine(*port(s), *port(s2)))


def test_fused_matches_pallas_interpret(rng):
    """k = 64, W = 128: the Pallas megakernels (interpret mode) vs the port."""
    s = summaries(rng, 2, 64, 0.6)
    win = zipf_window(rng, 2, 128, 512)
    pallas = fused_ingest_pallas(*(jnp.asarray(a) for a in (*s, win)), interpret=True)
    assert_same(pallas, ss_ingest.fused_ingest(*port(s), torch.from_numpy(win)))
    s2 = summaries(rng, 2, 64, 1.0, id_range=128)
    pallas = fused_combine_pallas(*(jnp.asarray(a) for a in (*s, *s2)), interpret=True)
    assert_same(pallas, ss_ingest.fused_combine(*port(s), *port(s2)))


def test_fused_engine_equals_jax_sorted_engine(rng, monkeypatch):
    """ingest → snapshot → estimate with kernel="fused", through the fused wrappers."""
    calls = {"ingest": 0, "combine": 0}
    for name in calls:
        real = getattr(ss_ingest, f"fused_{name}")

        def spy(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(ss_ingest, f"fused_{name}", spy)
    geom = dict(k=64, tenants=4, chunk=32, buffer_depth=2)
    je = JEngine(JConfig(kernel="sorted", **geom))
    te = SketchEngine(EngineConfig(kernel="fused", device="cpu", **geom))
    stream = np.minimum(rng.zipf(1.3, (4, 9 * 32 - 5)), 400).astype(np.int32)
    js, ts = je.ingest(je.init(), stream), te.ingest(te.init(), stream)
    assert calls["ingest"] == 4 and ts.fill == 1
    jsnap, tsnap = je.snapshot(js), te.snapshot(ts)
    assert calls["ingest"] == 5 and calls["combine"] == 2   # flush view + 2 tree rounds
    for a, b in zip(jsnap.summary, tsnap.summary):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jsnap.n) == int(tsnap.n) and tsnap.kernel == "fused"
    q = np.concatenate([np.asarray(jsnap.summary.items)[:20],
                        rng.integers(-1, 500, 20)]).astype(np.int32)
    for a, b in zip(je.estimate(js, q), te.estimate(ts, q)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(je.estimate(js, q), QueryFrontend("fused").estimate(tsnap, q)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fused_wrappers_check_their_inputs(rng):
    s = port(summaries(rng, 2, 16, 0.5))
    win = torch.from_numpy(zipf_window(rng, 2, 40, 128))
    with pytest.raises(ValueError, match=r"\(B, k\)"):
        ss_ingest.fused_ingest(*(a[0] for a in s), win[0])
    with pytest.raises(ValueError, match="window"):
        ss_ingest.fused_ingest(*s, win[:1])
    with pytest.raises(TypeError):
        ss_ingest.fused_ingest(*s, win.long())
    with pytest.raises(TypeError):
        ss_ingest.fused_ingest(s[0], s[1].long(), s[2], win)
    with pytest.raises(ValueError, match="contiguous"):
        ss_ingest.fused_ingest(*s, win[:, ::2])
    with pytest.raises(ValueError, match="at least one counter"):
        ss_ingest.fused_ingest(*(a[:, :0] for a in s), win)
    with pytest.raises(ValueError, match="summaries"):
        ss_ingest.fused_combine(*s, *(a[:1] for a in s))
    with pytest.raises(TypeError, match="differ"):
        ss_ingest.fused_combine(*s, s[0], s[1].long(), s[2].long())
    # the plain versions are the library merge with the sorted matcher
    for a, b in zip(ss_ingest.fused_ingest(*s, win), ref.fused_ingest_ref(*s, win)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op,b,k,w", [("ingest", 2, 4096, 65536), ("combine", 2, 8192, 0)])
def test_plain_versions_equal_jax_above_the_old_limits(rng, op, b, k, w):
    """The plain versions the card's kernels are held to, at shapes above the
    shared-memory path's limits (the cluster path's, by the rule): JAX's
    update_chunk / combine with the sorted matcher (its ``ingest_window`` /
    ``combine_summaries`` under 'sorted'), bitwise, at k 4096 × W 65 536 (a
    window past 16-bit counts) and COMBINE at k 8192."""
    assert ss_ingest.path_for(k, w, b, at_once=H100_AT_ONCE) == "cluster"
    s = summaries(rng, b, k, 1.0, id_range=4 * k)
    if op == "ingest":
        win = zipf_window(rng, b, w, 4 * k)
        win[1, ::3] = s[0][1, rng.integers(0, k, len(win[1, ::3]))]
        want = jax_ingest(*s, win)
        assert_same(want, ref.fused_ingest_ref(*port(s), torch.from_numpy(win)))
        assert_same(want, ss_ingest.fused_ingest(*port(s), torch.from_numpy(win)))
    else:
        s2 = summaries(rng, b, k, 0.9, id_range=4 * k)
        want = jax_combine(s, s2)
        assert_same(want, ref.fused_combine_ref(*port(s), *port(s2)))
        assert_same(want, ss_ingest.fused_combine(*port(s), *port(s2)))


@pytest.mark.parametrize("k,w,b,path,c", [
    (1, 0, 1, "smem", None), (2048, 16384, 64, "smem", None), (2049, 0, 1, "cluster", 8),
    (2048, 16385, 2, "cluster", 8), (64, 65536, 1, "cluster", 16),
    (16384, 131072, 2, "cluster", 16), (2048, 65536, 64, "cluster", 4),
    (2048, 16 * 16384 + 1, 1, "workspace", None)])
def test_path_and_workspace_of_each_shape(k, w, b, path, c):
    """The shared-memory path takes k ≤ 2048 and W ≤ 16 384; the cluster
    path the shapes a cluster of at most 16 blocks holds (the planned flush,
    B 64 × W 65 536, on clusters of 4; few tenants on clusters of 8, or 16
    above k + W = 65 536); the workspace path the rest, a window past 16
    slices of 16 384 ids among them. The workspace buffer holds, a tenant,
    the updated counts and errors, two k-rank buffers and two W + 1
    buffers (COMBINE: five k-entry int32 buffers), 16-byte aligned."""
    assert ss_ingest.path_for(k, w, b, at_once=H100_AT_ONCE) == path
    assert ss_ingest.cluster_for(k, w, b, at_once=H100_AT_ONCE) == c or path != "cluster"
    if path == "workspace":
        assert ss_ingest.cluster_for(k, w, b, at_once=H100_AT_ONCE) is None
    for dtype, t in ((torch.int32, 4), (torch.int64, 8)):
        per = -(-(2 * k * t + (2 * k + 2 * (w + 1)) * 4) // 16) * 16
        assert ss_ingest.workspace_bytes(3, k, w, dtype) == 3 * per
        per = -(-(2 * k * t + 5 * k * 4) // 16) * 16
        assert ss_ingest.workspace_bytes(3, k, None, dtype) == 3 * per
    # the planned flush: B 64, k 2048, W 65 536 at int32, 35.7 MB
    assert ss_ingest.workspace_bytes(64, 2048, 65536, torch.int32) == 64 * 557072


@pytest.mark.parametrize("b,dtype,path", [(64, torch.int32, "cluster"),
                                          (64, torch.int64, "workspace"),
                                          (8, torch.int64, "cluster")])
def test_path_rule_takes_one_round_of_clusters_at_the_sweeps_shape(b, dtype, path):
    """The paper's k sweep flushes k 8000 × W 16 384 for 64 tenants: at int32
    a cluster of 2 holds it and the card runs all 64 clusters at once; at
    int64 it needs 4 blocks, 64 clusters of 4 take three rounds of the
    card's 30, and the workspace kernel's one block a tenant is faster, so
    the rule gives it the workspace path; at B 8 the cluster path again."""
    assert ss_ingest.path_for(8000, 16384, b, dtype, H100_AT_ONCE) == path
    assert ss_ingest.cluster_for(8000, 16384, b, dtype, H100_AT_ONCE) == (
        2 if dtype == torch.int32 else (4 if b == 64 else 8))


CLUSTER_SHAPES = [(k, w, b) for k in (2049, 4000, 8000, 16384, 65536, 262144)
                  for w in (0, 16385, 65536, 131072, 262144) for b in (1, 8, 64)]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k,w", sorted({(k, w) for k, w, _ in CLUSTER_SHAPES}))
def test_cluster_path_fits_one_block_of_shared_memory(k, w, dtype):
    """Every shape the rule routes to the cluster path, at each count type:
    C one of 2, 4, 8, 16; slices of at most 16 384 window ids and summary
    slots (the sort's 16-bit counters and ranks); at most 232 448 bytes of
    shared memory a block (the flush's, and for W = 0 the COMBINE's too);
    and no smaller size that holds the shape is skipped. Every other shape
    goes to the workspace kernel, because no cluster holds it or, at
    W ≤ 16 384, because its b clusters take more than one round of the
    card."""
    for b in (1, 8, 64):
        c = ss_ingest.cluster_for(k, w, b, dtype, H100_AT_ONCE)
        if ss_ingest.path_for(k, w, b, dtype, H100_AT_ONCE) != "cluster":
            assert ss_ingest.path_for(k, w, b, dtype, H100_AT_ONCE) == "workspace"
            assert c is None or (b > H100_AT_ONCE[c] and w <= ss_ingest.SMEM_W)
            assert (c is None) == (not any(ss_ingest.cluster_fits(k, w, s, dtype)
                                           for s in ss_ingest.CLUSTER_SIZES))
            continue
        assert c in ss_ingest.CLUSTER_SIZES
        assert -(-k // c) <= ss_ingest.SMEM_W and -(-w // c) <= ss_ingest.SMEM_W
        assert ss_ingest.cluster_smem_bytes(k, w, c, dtype) <= 232448
        if w == 0:
            assert ss_ingest.cluster_smem_bytes(k, None, c, dtype) <= 232448
        assert c >= min(s for s in ss_ingest.CLUSTER_SIZES
                        if ss_ingest.cluster_fits(k, w, s, dtype))
