"""repro_torch.core against repro.core: the same numpy inputs, the same bits.

Every case feeds one seeded numpy input to the JAX function (dense ``jnp``
matcher) and to its PyTorch counterpart on the CPU, and asserts exact
equality of (items, counts, errors), order included. Summaries are built
directly in numpy: distinct ids at shuffled positions, small counts with
many ties, EMPTY slots carrying zeros — empty, partly full and full.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.combine import combine as jcombine
from repro.core.combine import empty_like as jempty_like
from repro.core.combine import reduce_summaries as jreduce_summaries
from repro.core import exact as jexact
from repro.core import spacesaving as jss
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro_torch.core import combine as tcomb
from repro_torch.core import exact as texact
from repro_torch.core import spacesaving as tss
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops

# one intra-op thread per test process: the suite runs in parallel
# workers, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

JMATCH = functools.partial(jops.combine_match, impl="jnp")
FILLS = ("empty", "partial", "full")
KS = (64, 2048)


def tmatch(impl):
    return functools.partial(tops.combine_match, impl=impl)


def make_summary(rng, k, fill, id_range):
    """(items, counts, errors) numpy: distinct ids, tied counts, shuffled."""
    n_valid = {"empty": 0, "partial": k // 3, "full": k}[fill]
    items = np.full(k, -1, np.int32)
    counts = np.zeros(k, np.int32)
    errors = np.zeros(k, np.int32)
    pos = rng.permutation(k)[:n_valid]
    items[pos] = rng.choice(id_range, n_valid, replace=False)
    counts[pos] = rng.integers(1, 6, n_valid)
    errors[pos] = rng.integers(0, 3, n_valid) % counts[pos]
    return items, counts, errors


def make_chunk(rng, c, id_range):
    """A chunk with repeats, misses and EMPTY padding."""
    chunk = rng.integers(0, id_range, c).astype(np.int32)
    chunk[: c // 4] = rng.integers(0, 8, c // 4)          # heavy repeats
    chunk[rng.random(c) < 0.1] = -1                         # padding
    return chunk


def jsum(items, counts, errors):
    return jss.Summary(jnp.asarray(items), jnp.asarray(counts), jnp.asarray(errors))


def tsum(items, counts, errors):
    return tss.Summary(*(torch.from_numpy(np.array(a))
                         for a in (items, counts, errors)))


def assert_same(j, t):
    for a, b in zip(j, t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


_j_update = jax.jit(lambda s, ch: jss.update_chunk(s, ch, match_fn=JMATCH))
_j_absorb = jax.jit(lambda s, i, c, e, m2: jss.absorb_pool(s, i, c, e, m2=m2,
                                                           match_fn=JMATCH))


@pytest.mark.parametrize("c", [1, 37, 512])
def test_chunk_histogram_bitwise(c):
    rng = np.random.default_rng(c)
    chunks = np.stack([make_chunk(rng, c, 50) for _ in range(3)])
    chunks[2] = -1                                          # all padding
    ti, tw = tss.chunk_histogram(torch.from_numpy(chunks))
    for b in range(3):
        ji, jw = jss.chunk_histogram(jnp.asarray(chunks[b]))
        np.testing.assert_array_equal(np.asarray(ji), ti[b].numpy())
        np.testing.assert_array_equal(np.asarray(jw), tw[b].numpy())
    assert ti.dtype == torch.int32 and tw.dtype == torch.int32


def test_merge_pool_keeps_lower_index_on_ties():
    """Deliberately tied counts: the stable sort must pick lax.top_k's order."""
    rng = np.random.default_rng(3)
    for trial in range(5):
        k, c = 16, 40
        s = [a for a in make_summary(rng, k, "full", 1000)]
        s[1][:] = rng.integers(1, 3, k)                      # counts in {1, 2}
        ci = rng.choice(np.arange(1000, 2000), c, replace=False).astype(np.int32)
        cc = rng.integers(-1, 3, c).astype(np.int32)
        ce = np.zeros(c, np.int32)
        j = jss.merge_pool(jsum(*s), jnp.asarray(ci), jnp.asarray(cc), jnp.asarray(ce))
        t = tss.merge_pool(tsum(*s), torch.from_numpy(ci), torch.from_numpy(cc),
                           torch.from_numpy(ce))
        assert_same(j, t)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("k", KS)
def test_update_chunk_bitwise(k, fill):
    """Batched update over 2 tenants, each held against the JAX update."""
    rng = np.random.default_rng(k + len(fill))
    id_range = 3 * k
    states = [make_summary(rng, k, fill, id_range) for _ in range(2)]
    chunks = np.stack([make_chunk(rng, 512, id_range) for _ in range(2)])
    batched = tsum(*(np.stack(a) for a in zip(*states)))
    for impl in ("torch", "sorted"):
        out = tss.update_chunk(batched, torch.from_numpy(chunks), match_fn=tmatch(impl))
        for b in range(2):
            assert_same(_j_update(jsum(*states[b]), jnp.asarray(chunks[b])),
                        tss.Summary(*(a[b] for a in out)))


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("k", KS)
def test_absorb_pool_with_errors_bitwise(k, fill):
    """Summary-vs-summary absorb (the COMBINE core) with m₂ and errors."""
    rng = np.random.default_rng(7 * k + len(fill))
    s = make_summary(rng, k, fill, 3 * k)
    cand = make_summary(rng, k, "full", 3 * k)
    m2 = int(cand[1].min())
    j = _j_absorb(jsum(*s), *(jnp.asarray(a) for a in cand), m2)
    for impl in ("torch", "sorted"):
        t = tss.absorb_pool(tsum(*s), *(torch.from_numpy(a) for a in cand), m2=m2,
                            match_fn=tmatch(impl))
        assert_same(j, t)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("k", KS)
def test_spacesaving_scan_bitwise(k, fill):
    """The sequential oracle, from a mid-stream state."""
    rng = np.random.default_rng(11 * k + len(fill))
    s = make_summary(rng, k, fill, 3 * k)
    stream = make_chunk(rng, 200, 3 * k)
    assert_same(jss.spacesaving_scan(jsum(*s), jnp.asarray(stream)),
                tss.spacesaving_scan(tsum(*s), torch.from_numpy(stream)))


def test_spacesaving_chunked_and_merge_histogram_bitwise():
    rng = np.random.default_rng(5)
    k, c = 64, 128
    stream = make_chunk(rng, 4 * c, 400)
    j = jss.spacesaving_chunked(jss.init_summary(k), jnp.asarray(stream), chunk_size=c)
    t = tss.spacesaving_chunked(tss.init_summary(k, device="cpu"),
                                torch.from_numpy(stream), chunk_size=c)
    assert_same(j, t)
    hi, hw = jss.chunk_histogram(jnp.asarray(stream[:c]))
    assert_same(jss.merge_histogram(j, hi, hw, match_fn=JMATCH),
                tss.merge_histogram(t, torch.from_numpy(np.array(hi)),
                                    torch.from_numpy(np.array(hw))))
    with pytest.raises(ValueError):
        tss.spacesaving_chunked(t, torch.from_numpy(stream[:c + 1]), chunk_size=c)


@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_combine_and_reduce_summaries_bitwise(p):
    rng = np.random.default_rng(p)
    k = 64
    fills = [FILLS[i % 3] for i in range(p)]
    stack = [np.stack(a) for a in zip(*(make_summary(rng, k, f, 200) for f in fills))]
    j = jreduce_summaries(jsum(*stack), match_fn=JMATCH)
    for impl in ("torch", "sorted"):
        assert_same(j, tcomb.reduce_summaries(tsum(*stack), match_fn=tmatch(impl)))
    if p >= 2:
        a, b = (tuple(x[i] for x in stack) for i in (0, 1))
        assert_same(jcombine(jsum(*a), jsum(*b), match_fn=JMATCH),
                    tcomb.combine(tsum(*a), tsum(*b)))


def test_reduce_pair_fn_hook_and_identity():
    rng = np.random.default_rng(9)
    stack = [np.stack(a) for a in zip(*(make_summary(rng, 32, "full", 100)
                                        for _ in range(4)))]
    calls = []

    def pair(a, b):
        calls.append(a.items.shape[0])
        return tcomb.combine(a, b)

    plain = tcomb.reduce_summaries(tsum(*stack))
    hooked = tcomb.reduce_summaries(tsum(*stack), pair_fn=pair)
    assert calls == [2, 1]
    for x, y in zip(plain, hooked):
        assert torch.equal(x, y)
    one = tsum(*(a[0] for a in stack))
    ident = tcomb.combine(one, tcomb.empty_like(one))
    assert_same(jcombine(jsum(*(a[0] for a in stack)),
                              jempty_like(jsum(*(a[0] for a in stack))),
                              match_fn=JMATCH), ident)


@pytest.mark.parametrize("fill", FILLS)
def test_estimate_prune_sort_min_frequency_bitwise(fill):
    rng = np.random.default_rng(len(fill))
    k = 64
    s = make_summary(rng, k, fill, 200)
    q = np.concatenate([s[0][:20], rng.integers(-1, 300, 30)]).astype(np.int32)
    js, ts = jsum(*s), tsum(*s)
    for a, b in zip(jss.estimate(js, jnp.asarray(q)), tss.estimate(ts, torch.from_numpy(q))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jss.min_frequency(js)) == int(tss.min_frequency(ts))
    for n, km in ((0, 3), (500, 7), (40, 64)):
        for a, b in zip(jss.prune(js, n, km), tss.prune(ts, torch.tensor(n), km)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for asc in (True, False):
        assert_same(jss.sort_summary(js, asc), tss.sort_summary(ts, asc))
    with pytest.raises(ValueError):
        tss.prune(ts, 10, 0)


def test_pad_stream_matches():
    x = np.arange(10, dtype=np.int32)
    for m in (1, 4, 10, 16):
        np.testing.assert_array_equal(np.asarray(jss.pad_stream(jnp.asarray(x), m)),
                                      tss.pad_stream(torch.from_numpy(x), m).numpy())


@pytest.mark.parametrize("skew,fold,max_id", [(1.1, "mod", 10**6), (1.8, "mod", None),
                                              (1.3, "clip", 500)])
def test_zipf_stream_identical(skew, fold, max_id):
    a = jsyn.zipf_stream(5000, skew, seed=4, max_id=max_id, fold=fold)
    b = tsyn.zipf_stream(5000, skew, seed=4, max_id=max_id, fold=fold)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsyn.fold_ids(a, 10, "wrap")


def test_exact_copy_identical():
    stream = jsyn.zipf_stream(3000, 1.3, seed=2, max_id=200)
    stream[:10] = -1
    assert texact.exact_counts(torch.from_numpy(stream)) == jexact.exact_counts(stream)
    assert texact.true_heavy_hitters(stream, 16) == jexact.true_heavy_hitters(stream, 16)
    j = jss.spacesaving_chunked(jss.init_summary(32),
                                jnp.asarray(jss.pad_stream(jnp.asarray(stream), 500)),
                                chunk_size=500)
    t = tsum(*(np.asarray(a) for a in j))
    assert texact.evaluate(t, stream, 16) == jexact.evaluate(j, stream, 16)
    assert (texact.overestimation_violations(t, stream)
            == jexact.overestimation_violations(j, stream) == 0)


def test_int64_counts_equal_int32_counts():
    """Within the port: int64 summaries give the int32 values (n < 2^31)."""
    rng = np.random.default_rng(6)
    k = 64
    stream = torch.from_numpy(make_chunk(rng, 2048, 400))
    out = {}
    for dtype in (torch.int32, torch.int64):
        s = tss.init_summary(k, dtype, device="cpu", batch=(2,))
        for impl in ("torch", "sorted"):
            r = tss.spacesaving_chunked(s, stream.reshape(2, -1), chunk_size=256,
                                        match_fn=tmatch(impl))
            assert r.counts.dtype == dtype
            out[dtype, impl] = r
    base = out[torch.int32, "torch"]
    for r in out.values():
        assert torch.equal(r.items, base.items)
        assert torch.equal(r.counts.long(), base.counts.long())
        assert torch.equal(r.errors.long(), base.errors.long())
