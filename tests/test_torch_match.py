"""repro_torch's match_weights against repro's, and the kernel wrapper's CPU path.

The inputs of ``tests/test_kernels.py`` (its shapes; summary ids with
duplicates and EMPTY; a histogram of distinct ids, EMPTY-padded) go through
JAX's ``kernels.ref.match_weights_ref`` and the port's ``ops.match_weights``
under ``'torch'`` and ``'auto'``, and through the wrapper of the CUDA kernel,
which computes the plain version on a CPU tensor. ``'sorted'`` needs
distinct valid summary ids and is held against JAX on those. Everything is
bit for bit (integer sums). JAX runs without 64-bit types here, so int64
weights are held against an exact numpy sum. The kernel itself runs only on
a card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, ss_match
from repro_torch.plan import clear

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

SHAPES = [(8, 16), (100, 57), (512, 512), (1000, 300), (64, 2048), (2048, 64)]


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    """'auto' resolves against an empty plan cache: the static rule."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


def mk_inputs(rng, k, c, id_range=60):
    """``tests/test_kernels.py:_mk_inputs``: duplicate/EMPTY summary ids,
    a distinct-id histogram padded with EMPTY (weight 0)."""
    s_items = rng.integers(-1, id_range, k).astype(np.int32)
    hist = np.unique(rng.integers(0, id_range, c).astype(np.int32))
    h_items = np.full(c, -1, np.int32)
    h_items[:len(hist)] = hist
    h_weights = (rng.integers(1, 100, c) * (h_items != -1)).astype(np.int32)
    return s_items, h_items, h_weights


def distinct_ids(rng, k, id_range):
    """Distinct valid summary ids in 3/4 of the slots, EMPTY in the rest."""
    ids = np.full(k, -1, np.int32)
    n = min(k, id_range) * 3 // 4
    ids[rng.permutation(k)[:n]] = rng.choice(id_range, n, replace=False)
    return ids


def t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def assert_same(jout, tout):
    for a, b in zip(jout, tout, strict=True):
        a = np.asarray(a)
        assert b.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("k,c", SHAPES)
def test_dense_and_wrapper_equal_jax(rng, k, c):
    s, h, w = mk_inputs(rng, k, c)
    jout = jref.match_weights_ref(*map(jnp.asarray, (s, h, w)))
    for impl in ("torch", "auto"):
        assert_same(jout, ops.match_weights(*t(s, h, w), impl=impl))
    assert_same(jout, ss_match.match_weights(*t(s, h, w)))


@pytest.mark.parametrize("k,c", SHAPES)
def test_sorted_equals_jax_on_distinct_ids(rng, k, c):
    s = distinct_ids(rng, k, 4 * max(k, c))
    _, h, w = mk_inputs(rng, k, c, id_range=4 * max(k, c))
    jout = jref.match_weights_ref(*map(jnp.asarray, (s, h, w)))
    for impl in ("sorted", "fused", "torch"):
        assert_same(jout, ops.match_weights(*t(s, h, w), impl=impl))


def test_duplicate_histogram_ids_add_up(rng):
    """The dense contract sums duplicate ids on both sides, as JAX's does."""
    s = rng.integers(-1, 30, 200).astype(np.int32)
    h = rng.integers(-1, 30, 500).astype(np.int32)
    w = rng.integers(1, 1000, 500).astype(np.int32)
    jout = jref.match_weights_ref(*map(jnp.asarray, (s, h, w)))
    assert_same(jout, ops.match_weights(*t(s, h, w), impl="torch"))
    assert_same(jout, ss_match.match_weights(*t(s, h, w)))


def test_batched_rows_equal_each_row(rng):
    rows = [mk_inputs(rng, 300, 200) for _ in range(3)]
    s, h, w = (np.stack(a) for a in zip(*rows))
    got = ss_match.match_weights(*t(s, h, w))
    for i, row in enumerate(rows):
        jout = jref.match_weights_ref(*map(jnp.asarray, row))
        assert_same(jout, tuple(g[i] for g in got))


def test_int64_weights_and_empty_histogram(rng):
    """int64 sums past 2^32 (an exact numpy sum), and c = 0."""
    s = distinct_ids(rng, 256, 1000)
    h = rng.choice(1000, 700, replace=False).astype(np.int32)
    w = rng.integers(1, 1 << 40, 700).astype(np.int64)
    want = np.array([w[h == x].sum() if x != -1 else 0 for x in s], np.int64)
    for impl in ("torch", "sorted", "cuda"):
        fn = ss_match.match_weights if impl == "cuda" else \
            (lambda *a, _i=impl: ops.match_weights(*a, impl=_i))
        add_w, matched = fn(*t(s, h, w))
        assert add_w.dtype == torch.int64
        np.testing.assert_array_equal(add_w.numpy(), want)
        np.testing.assert_array_equal(matched.numpy(), np.isin(h, s[s != -1]))
    empty_h, empty_w = np.zeros(0, np.int32), np.zeros(0, np.int32)
    jout = jref.match_weights_ref(*map(jnp.asarray, (s, empty_h, empty_w)))
    for impl in ("torch", "sorted", "auto"):
        assert_same(jout, ops.match_weights(*t(s, empty_h, empty_w), impl=impl))
    assert_same(jout, ss_match.match_weights(*t(s, empty_h, empty_w)))


@pytest.mark.parametrize("k,kernel", [(8192, "hash"), (8193, "dense"), (20000, "dense")])
def test_wrapper_takes_any_k(rng, k, kernel):
    """No counter limit: on the card the hash join takes k up to its table's
    limit and the dense compare the rest (the shape rule of ss_combine); on
    a CPU tensor the wrapper equals JAX at either side of that limit."""
    from repro_torch.kernels import ss_combine
    assert ss_combine.kernel_for(2, k, 300, torch.int32, False) == kernel
    assert ss_combine.kernel_for(2, k, 300, torch.int64, False) == kernel
    s, h, w = mk_inputs(rng, k, 300, id_range=2 * k)
    jout = jref.match_weights_ref(*map(jnp.asarray, (s, h, w)))
    assert_same(jout, ss_match.match_weights(*t(s, h, w)))
    assert_same(jout, ops.match_weights(*t(s, h, w)))


def test_refusals(rng):
    s, h, w = t(*mk_inputs(rng, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.match_weights(s, h, w, impl="cuda")
    with pytest.raises(ValueError, match="not in"):
        ops.match_weights(s, h, w, impl="pallas")
    with pytest.raises(TypeError):
        ss_match.match_weights(s.long(), h, w)
    with pytest.raises(TypeError):
        ss_match.match_weights(s, h, w.float())
    with pytest.raises(ValueError):
        ss_match.match_weights(s, h, w[:4])
    with pytest.raises(ValueError):
        ss_match.match_weights(s[None], h, w)
    with pytest.raises(ValueError, match="contiguous"):
        ss_match.match_weights(s, h[::2], w[::2])
    assert ref.match_weights_ref is ss_match.match_weights_ref
