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

from repro.core.combine import combine as jcombine
from repro.core.spacesaving import Summary as JSummary
from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels.ref import combine_match_sorted
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


def hash_order_flush(items, counts, errors, window, rng):
    """One flush worked the way the shared-memory kernel works, in plain
    torch, row by row: the window's distinct ids with their counts in a
    shuffled order (the hash table's), the match, the k-th largest count of
    the pool, ties going to the summary slots in slot order and then to the
    tied candidates with the lowest ids, and a sort of the winners only."""
    out = [torch.empty_like(items), torch.empty_like(counts), torch.empty_like(errors)]
    dtype, k = counts.dtype, items.shape[-1]
    for r in range(items.shape[0]):
        s_items, s_counts, s_errors = items[r], counts[r].clone(), errors[r].clone()
        full = bool((s_items != -1).all())
        m1 = s_counts.min() if full else torch.zeros((), dtype=dtype)
        ids, weights = torch.unique(window[r][window[r] != -1], return_counts=True)
        shuffle = torch.from_numpy(rng.permutation(len(ids)))
        ids, weights = ids[shuffle], weights[shuffle].to(dtype)
        # the match: a slot adds its id's weight, and the id leaves the pool
        unmatched = torch.ones(len(ids), dtype=torch.bool)
        for i in range(k):
            if s_items[i] == -1:
                s_counts[i] = s_errors[i] = 0
                continue
            hit = (ids == s_items[i]).nonzero()
            if len(hit):
                s_counts[i] += weights[hit[0, 0]]
                unmatched[hit[0, 0]] = False
        c_ids, c_counts = ids[unmatched], weights[unmatched] + m1
        # the threshold over the entries that may win (count >= 0)
        s_ok, c_ok = s_counts >= 0, c_counts >= 0
        valid = torch.cat([s_counts[s_ok], c_counts[c_ok]])
        s_win, c_win = s_ok.clone(), c_ok.clone()
        if len(valid) > k:
            thr = valid.sort(descending=True).values[k - 1]
            ties = k - int((valid > thr).sum())
            s_tied = (s_counts == thr).nonzero()[:, 0]
            c_tied = (c_counts == thr).nonzero()[:, 0]
            s_win = s_counts > thr
            s_win[s_tied[:ties]] = True
            c_win = c_counts > thr
            c_win[c_tied[c_ids[c_tied].argsort()][:ties - min(ties, len(s_tied))]] = True
        # order the winners only: count descending, then summary slot, then id
        slots = s_win.nonzero()[:, 0]
        cands = c_win.nonzero()[:, 0]
        cands = cands[c_ids[cands].argsort()]
        w_counts = torch.cat([s_counts[slots], c_counts[cands]])
        order = w_counts.argsort(descending=True, stable=True)
        w_items = torch.cat([s_items[slots], c_ids[cands]])[order]
        w_errors = torch.cat([s_errors[slots], torch.full((len(cands),), int(m1),
                                                           dtype=dtype)])[order]
        n = len(order)
        for o, w, fill in zip(out, (w_items, w_counts[order], w_errors), (-1, 0, 0)):
            o[r] = fill
            o[r, :n] = w
    return tuple(out)


def _flush_case(rng, case):
    """Summaries (numpy) and a window for one case of the order rule."""
    b, k, w = 3, 128, 512
    if case == "k_above_distinct":
        s = summaries(rng, b, k, 0.1)
        win = np.minimum(rng.zipf(1.8, (b, w)), 40).astype(np.int32)
        return s, win
    s = summaries(rng, b, k, 1.0, count_hi=6 if case == "ties" else 1000)
    if case in ("zipf_1.1", "zipf_1.8", "ties"):
        win = np.minimum(rng.zipf(1.1 if case != "zipf_1.8" else 1.8, (b, w)),
                         4 * k).astype(np.int32)
        win[1, ::4] = s[0][1, rng.integers(0, k, w // 4)]    # ids the summary holds
    elif case == "all_distinct":
        win = np.stack([rng.permutation(8 * k)[:w] for _ in range(b)]).astype(np.int32)
    elif case == "all_equal":
        win = np.full((b, w), 7, np.int32)
        win[1] = s[0][1, 5]
    else:                                                  # EMPTY in window and summary
        s = summaries(rng, b, k, 0.6)
        win = zipf_window(rng, b, w, 4 * k)
    return s, win


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["zipf_1.1", "zipf_1.8", "all_distinct", "all_equal",
                                  "empty_ids", "ties", "k_above_distinct"])
def test_hash_order_rule_equals_jax_and_plain(rng, case, dtype):
    """The shared-memory kernel's order rule (an unordered histogram, a
    threshold, ties to summary slots then to the lowest ids, only the
    winners sorted) is bitwise JAX's sorted flush and the plain version."""
    s, win = _flush_case(rng, case)
    args = (*port(s, dtype), torch.from_numpy(win))
    got = hash_order_flush(*args, rng)
    assert_same(jax_ingest(*s, win), got, getattr(torch, np.dtype(dtype).name))
    for a, b in zip(got, ref.fused_ingest_ref(*args)):
        assert torch.equal(a, b)


def test_hash_order_rule_with_wrapping_counts(rng):
    """int32 counts that wrap past 2^31 - 1: an entry whose count turns
    negative never wins, in the order rule and in the plain version."""
    s = summaries(rng, 3, 128, 1.0, count_hi=6)
    counts = (s[1].astype(np.int64) + (2**31 - 8) * (s[0] >= 0)).astype(np.int32)
    s = (s[0], counts, counts // 4)
    win = rng.integers(0, 400, (3, 512)).astype(np.int32)
    win[0, :64] = s[0][0, :64]
    args = (*port(s), torch.from_numpy(win))
    got = hash_order_flush(*args, rng)
    assert (got[1] < 0).sum() == 0 and (args[1] + 5 < 0).any()
    assert_same(jax_ingest(*s, win), got)
    for a, b in zip(got, ref.fused_ingest_ref(*args)):
        assert torch.equal(a, b)


def hash_order_combine(a_items, a_counts, a_errors, b_items, b_counts, b_errors, rng):
    """One COMBINE worked the way the shared-memory kernel works, in plain
    torch, row by row: s2's valid ids matched through a table filled in a
    shuffled order (each id keeps its lowest slot), one threshold (the k-th
    largest count of the pool [s1 | s2's unmatched slots]) with ties to the
    lowest pool rank, and a sort of the winners only."""
    out = [torch.empty_like(a_items), torch.empty_like(a_counts), torch.empty_like(a_errors)]
    dtype, k = a_counts.dtype, a_items.shape[-1]
    zero = torch.zeros((), dtype=dtype)
    for r in range(a_items.shape[0]):
        i1, c1, e1 = a_items[r], a_counts[r].clone(), a_errors[r].clone()
        i2, c2, e2 = b_items[r], b_counts[r], b_errors[r]
        m1 = c1.min() if bool((i1 != -1).all()) else zero
        m2 = c2.min() if bool((i2 != -1).all()) else zero
        # the table: s2's valid ids inserted in a shuffled order
        table = {}
        valid2 = (i2 != -1).nonzero()[:, 0]
        for j in valid2[torch.from_numpy(rng.permutation(len(valid2)))].tolist():
            table[int(i2[j])] = min(table.get(int(i2[j]), j), j)
        # the probe: a hit adds s2's count and error and takes that slot out
        taken = torch.zeros(k, dtype=torch.bool)
        for i in range(k):
            if i1[i] == -1:
                c1[i] = e1[i] = 0
                continue
            j = table.get(int(i1[i]))
            if j is None:
                c1[i] += m2
                e1[i] += m2
            else:
                c1[i] += c2[j]
                e1[i] += e2[j]
                taken[j] = True
        join = (i2 != -1) & ~taken
        pool_c = torch.cat([c1, torch.where(join, c2 + m1, torch.full_like(c2, -1))])
        pool_i, pool_e = torch.cat([i1, i2]), torch.cat([e1, e2 + m1])
        # one threshold; ties to the lowest pool ranks
        win = pool_c >= 0
        if int(win.sum()) > k:
            thr = pool_c[win].sort(descending=True).values[k - 1]
            tied = (pool_c == thr).nonzero()[:, 0]
            win = pool_c > thr
            win[tied[:k - int(win.sum())]] = True
        # the winners only, by count descending, then pool rank
        ranks = win.nonzero()[:, 0]
        ranks = ranks[pool_c[ranks].argsort(descending=True, stable=True)]
        n = len(ranks)
        for o, w, fill in zip(out, (pool_i, pool_c, pool_e), (-1, 0, 0)):
            o[r] = fill
            o[r, :n] = w[ranks]
    return tuple(out)


_jax_combine_sorted = jax.jit(jax.vmap(lambda s1, s2: tuple(jcombine(
    JSummary(*s1), JSummary(*s2), match_fn=combine_match_sorted))))


def _combine_case(rng, case):
    """Two batches of summaries (numpy) for one case of the COMBINE's rule."""
    b, k = 3, 256
    if case == "k_1":
        return summaries(rng, 4, 1, 1.0, id_range=2), summaries(rng, 4, 1, 1.0, id_range=2)
    if case == "both_empty":
        return summaries(rng, b, k, 0.0), summaries(rng, b, k, 0.0)
    if case == "ties":
        return (summaries(rng, b, k, 1.0, count_hi=4, id_range=400),
                summaries(rng, b, k, 0.8, count_hi=4, id_range=400))
    if case == "partial":                          # EMPTY slots in s1 and in s2
        return summaries(rng, b, k, 0.5, id_range=512), summaries(rng, b, k, 0.3, id_range=512)
    s1 = summaries(rng, b, k, 1.0, id_range=512)
    s2 = summaries(rng, b, k, 0.8, id_range=512)
    if case == "disjoint":
        s2 = (np.where(s2[0] >= 0, s2[0] + 10_000, -1).astype(np.int32), *s2[1:])
    elif case == "identical":
        s2 = (np.stack([rng.permutation(row) for row in s1[0]]), *s2[1:])
    return s1, s2


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["random", "ties", "partial", "disjoint", "identical",
                                  "both_empty", "k_1"])
def test_hash_order_combine_equals_jax_and_plain(rng, case, dtype):
    """The shared-memory COMBINE's order rule (s2's ids matched through a
    table filled in a shuffled order, one threshold with ties to the lowest
    pool rank, only the winners sorted) is bitwise JAX's combine with the
    sorted matcher and the plain version."""
    s1, s2 = _combine_case(rng, case)
    args = (*port(s1, dtype), *port(s2, dtype))
    got = hash_order_combine(*args, rng)
    want = _jax_combine_sorted(tuple(jnp.asarray(a) for a in s1),
                               tuple(jnp.asarray(a) for a in s2))
    assert_same(want, got, getattr(torch, np.dtype(dtype).name))
    for a, b in zip(got, ref.fused_combine_ref(*args)):
        assert torch.equal(a, b)


def test_hash_order_combine_with_wrapping_counts(rng):
    """int32 counts that wrap past 2^31 - 1: an entry whose count turns
    negative never wins, in the COMBINE's rule and in the plain version."""
    s1 = summaries(rng, 3, 128, 1.0, count_hi=6, id_range=256)
    counts = (s1[1].astype(np.int64) + (2**31 - 8) * (s1[0] >= 0)).astype(np.int32)
    s1 = (s1[0], counts, counts // 4)
    s2 = summaries(rng, 3, 128, 0.9, count_hi=6, id_range=256)
    args = (*port(s1), *port(s2))
    got = hash_order_combine(*args, rng)
    assert (got[1] < 0).sum() == 0 and (args[1] + 5 < 0).any()
    want = _jax_combine_sorted(tuple(jnp.asarray(a) for a in s1),
                               tuple(jnp.asarray(a) for a in s2))
    assert_same(want, got)
    for a, b in zip(got, ref.fused_combine_ref(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_smem_combine_table_and_shared_memory_fit(dtype):
    """The shared-memory COMBINE's hash table holds s2's k ids at a load of
    at most 1/4 with a free slot, and its shared memory (the winners' sort
    buffer, the pool, the table and the static scratch) fits one block's
    232 448 bytes at every k up to 2048."""
    for k in range(1, ss_ingest.SMEM_K + 1):
        n = ss_ingest.join_slots(k)
        assert n > k and 4 * k <= n and n % 8 == 0
        need = ss_ingest.combine_smem_bytes(k, dtype) + ss_ingest.COMBINE_SMEM_STATIC
        assert need <= ss_ingest.SMEM_LIMIT
    assert ss_ingest.path_for(ss_ingest.SMEM_K, 0, 32, dtype) == "smem"
    t = 4 if dtype == torch.int32 else 8
    big = ss_ingest.combine_smem_bytes(2048, dtype)
    assert big == 2048 * 2 * t + 2 * 4096 * t + 4096 * 4 + 8192 * 8
    assert big == (131072 if dtype == torch.int32 else 180224)   # the source's static_assert


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k,w", [(1, 0), (1, 1), (300, 12345), (2048, 16383), (2048, 16384)])
def test_smem_flush_table_and_shared_memory_fit(k, w, dtype):
    """The shared-memory flush's hash table holds every distinct id of a
    window (at least 1.5 W slots and more than W: a load of at most 2/3 and
    a free slot, so a probe ends), and its shared memory (the winners' sort buffer, the
    summary, the table and the static scratch) fits one block's 232 448
    bytes up to k 2048 × W 16 384 at int64."""
    n = ss_ingest.table_slots(w)
    assert n > w and 3 * w <= 2 * n and n % 8 == 0
    need = ss_ingest.smem_bytes(k, w, dtype) + ss_ingest.SMEM_STATIC
    assert need <= ss_ingest.SMEM_LIMIT
    assert ss_ingest.path_for(k, w, 64, dtype) == "smem"
    if (k, w, dtype) == (2048, 16384, torch.int64):
        assert need == 2048 * 16 + 2 * 16384 + 8192 + 24576 * 6 + 2336 == 223520


def mix32(h):
    """murmur3's 32-bit finaliser of each word of a uint32 numpy array, as
    ``ss_hash::mix32``."""
    h = np.asarray(h, np.uint32).astype(np.uint64)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def home_slot(ids, w, salt):
    """The home slot of each id in the shared-memory flush's table for
    windows of w ids under the key ``salt``, as ``ss_hash::slot_in``: the
    high half of the 32 × 32-bit product of mix32(id ^ salt) with
    table_slots(w)."""
    x = np.asarray(ids, np.int32).view(np.uint32) ^ np.uint32(salt)
    return (mix32(x) * ss_ingest.table_slots(w)) >> 32


def fibonacci_chain_ids(n, w):
    """n distinct ids > 0 whose home slot under the unkeyed Fibonacci hash
    (x · 0x9E3779B1 mod 2^32, reduced to table_slots(w) slots by the high
    half of a product) is slot 0: a window of them probes one chain of a
    table with that public hash. x = y · 0x9E3779B1^-1 mod 2^32 for y below
    2^32 / table_slots(w)."""
    n_slots = ss_ingest.table_slots(w)
    y = np.arange((2**32 - 1) // n_slots, dtype=np.uint64)
    x = (y * pow(0x9E3779B1, -1, 2**32)) & 0xFFFFFFFF
    ids = x[(x > 0) & (x < 2**31 - 1)][:n]
    assert len(ids) == n and not (((ids * 0x9E3779B1) & 0xFFFFFFFF) * n_slots >> 32).any()
    return ids.astype(np.int32)


def probes_to_insert(ids, w, salt):
    """Mean slots probed to insert each of the distinct ``ids`` into the
    table of a window of w ids by linear probing from home_slot."""
    n = ss_ingest.table_slots(w)
    taken = np.zeros(n, bool)
    probes = 0
    for p in home_slot(ids, w, salt).tolist():
        probes += 1
        while taken[p]:
            p = p + 1 if p + 1 < n else 0
            probes += 1
        taken[p] = True
    return probes / len(ids)


def test_home_slot_mirrors_the_table_hash():
    """``home_slot`` is ss_hash.cuh's slot_in: mix32(x ^ salt) · n >> 32 for
    the table of n = table_slots(W) slots, EMPTY and negative ids taken as
    their 32-bit patterns; checked against the finaliser worked on Python
    ints, one id at a time."""
    def one(x, salt, n):
        h = (x % 2**32) ^ salt
        h ^= h >> 16
        h = h * 0x85EBCA6B % 2**32
        h ^= h >> 13
        h = h * 0xC2B2AE35 % 2**32
        return (h ^ h >> 16) * n >> 32

    ids = np.array([0, 1, 7, 2**31 - 1, -1, -2**31, 123456789], np.int32)
    for w, salt in ((1, 0), (100, 0x12345678), (16384, 2**32 - 1)):
        n = ss_ingest.table_slots(w)
        want = [one(int(x), salt, n) for x in ids]
        assert home_slot(ids, w, salt).tolist() == want
        assert all(0 <= s < n for s in want)
    assert mix32(np.arange(1 << 16)).size == np.unique(mix32(np.arange(1 << 16))).size


@pytest.mark.parametrize("salt", [0, 1, 0x9E3779B1, 0xDEADBEEF])
@pytest.mark.parametrize("case", ["fibonacci_chain", "all_distinct"])
def test_keyed_hash_spreads_a_window_built_to_collide(case, salt):
    """W = 16 384 distinct ids that all share one home slot under the public
    Fibonacci hash (each insert would probe ~W/2 slots) cost the keyed
    table about what W random distinct ids cost: within 2× of linear
    probing's ½(1 + 1/(1 − α)) = 2 probes an insert at the table's load of
    2/3, whatever the salt."""
    w = 16384
    rng = np.random.default_rng(salt)
    ids = (fibonacci_chain_ids(w, w) if case == "fibonacci_chain"
           else rng.permutation(8 * 2048)[:w].astype(np.int32))
    assert probes_to_insert(ids, w, salt) <= 2 * 2.0