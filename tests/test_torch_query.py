"""The point-query wrapper (``repro_torch.kernels.ss_query``) on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_gpu.py``); here the
wrapper's shape rule, its table and block geometry, its launch bounds, and
its answers on CPU tensors (the plain version, for every kernel name) are
held against their definitions and against the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref, ss_query

torch.set_num_threads(1)


# (k, count dtype) -> the kernel of the shape rule
RULE = [
    ((0, torch.int32), "hash"),
    ((1, torch.int64), "hash"),
    ((32, torch.int32), "hash"),
    ((32, torch.int64), "hash"),
    ((33, torch.int32), "hash"),
    ((33, torch.int64), "hash"),
    ((2048, torch.int32), "hash"),       # the frontend's rows
    ((4096, torch.int64), "hash"),
    ((4097, torch.int64), "dense"),
    ((8192, torch.int32), "hash"),
    ((8192, torch.int64), "dense"),
    ((8193, torch.int32), "dense"),
]


@pytest.mark.parametrize("shape,want", RULE)
def test_kernel_for_shape_rule(shape, want):
    """'hash' where the table fits (k <= 8192 at int32, k <= 4096 at int64),
    small rows included, 'dense' above; the batch and the number of queries
    do not move the rule."""
    k, dtype = shape
    for b, nq in ((1, 16), (65537, 16), (1, 4096)):
        assert ss_query.kernel_for(b, k, nq, dtype) == want
    assert ss_query.check_launch(1, k, 256, dtype) == want


# (k, count dtype) -> (table slots, table bytes, fits in 227 KB)
TABLES = [
    ((0, torch.int32), (64, 768, True)),
    ((32, torch.int32), (64, 768, True)),
    ((33, torch.int32), (128, 1536, True)),
    ((2048, torch.int32), (4096, 49152, True)),
    ((2048, torch.int64), (4096, 81920, True)),
    ((2049, torch.int32), (8192, 98304, True)),
    ((4096, torch.int64), (8192, 163840, True)),
    ((4097, torch.int64), (16384, 327680, False)),
    ((8192, torch.int32), (16384, 196608, True)),
    ((8193, torch.int32), (32768, 393216, False)),
]


@pytest.mark.parametrize("shape,want", TABLES)
def test_table_size_and_fit(shape, want):
    """Slots are the least power of two >= 2k (at least 64); a slot takes an
    int32 id and two sums of the count type; the table fits where it takes
    at most 227 KB of shared memory."""
    k, dtype = shape
    assert ss_query.SMEM_BYTES == 227 * 1024
    assert (ss_query.table_slots(k), ss_query.table_bytes(k, dtype),
            ss_query.hash_fits(k, dtype)) == want


@pytest.mark.parametrize("k,want", [(33, (128, 1024)), (128, (128, 1024)),
                                    (129, (256, 1024)), (1000, (1024, 1024)),
                                    (2048, (1024, 2048)), (8192, (1024, 8192))])
def test_hash_block_geometry(k, want):
    """Threads grow with k (128 to 1024); a block takes max(k, 1024) queries,
    so that its k inserts are no more than its probes."""
    assert ss_query.block_geometry("hash", k) == want


@pytest.mark.parametrize("k", [0, 8193, 100_000])
def test_dense_block_geometry(k):
    """A dense block takes one query a thread, 128 of them, whatever k is."""
    assert ss_query.block_geometry("dense", k) == (128, 128)


# (kernel, k, count dtype) -> the C entry's arguments after (batch, k, nq)
LAUNCH_ARGS = [
    (("hash", 0, torch.int32), (6, 768, 128, 1024)),
    (("hash", 16, torch.int32), (6, 768, 128, 1024)),
    (("hash", 2048, torch.int32), (12, 49152, 1024, 2048)),
    (("hash", 2048, torch.int64), (12, 81920, 1024, 2048)),
    (("hash", 8192, torch.int32), (14, 196608, 1024, 8192)),
    (("dense", 8193, torch.int32), (128,)),
]


@pytest.mark.parametrize("shape,want", LAUNCH_ARGS)
def test_launch_args_carry_the_wrappers_geometry(shape, want):
    """The wrapper passes its own geometry to the C entries: the table's log2
    slots and bytes, the block's threads and its queries (hash), or the
    block's threads (dense)."""
    assert ss_query._launch_args(*shape) == want


# (kernel, k, count dtype, batch, queries that still fit, queries that do not)
LAUNCHES = [
    # k 16: a block takes 1024 queries
    ("hash", 16, torch.int32, 2**24, 2**16, 2**17),
    # k 2048: a block takes 2048 queries
    ("hash", 2048, torch.int32, 2**20, 2**21, 2**22),
    ("hash", 40, torch.int64, 2**21, 2**19, 2**20),   # 1024 queries a block
    # 128 queries a block
    ("dense", 8193, torch.int32, 2**24, 2**13, 2**14),
    ("dense", 16, torch.int32, 2**24, 2**13, 2**14),
]


@pytest.mark.parametrize("kernel,k,dtype,b,fits,refused", LAUNCHES)
def test_check_launch_bounds_the_blocks_of_each_kernel(kernel, k, dtype, b, fits, refused):
    per_block = ss_query.block_geometry(kernel, k)[1]
    assert b * -(-fits // per_block) <= ss_query.MAX_BLOCKS
    assert b * -(-refused // per_block) > ss_query.MAX_BLOCKS
    assert ss_query.check_launch(b, k, fits, dtype, kernel) == kernel
    with pytest.raises(ValueError, match="blocks"):
        ss_query.check_launch(b, k, refused, dtype, kernel)


def test_check_launch_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="shared memory"):
        ss_query.check_launch(1, 8193, 16, torch.int32, "hash")
    with pytest.raises(ValueError, match="shared memory"):
        ss_query.check_launch(1, 4097, 16, torch.int64, "hash")
    with pytest.raises(ValueError, match="kernel"):
        ss_query.check_launch(1, 16, 16, torch.int32, "sorted")
    with pytest.raises(ValueError, match="2\\^31"):
        ss_query.check_launch(1, 16, 2**31, torch.int32)
    assert ss_query.check_launch(1, 8193, 16, torch.int32, "dense") == "dense"
    assert ss_query.check_launch(1, 16, 16, torch.int32, "dense") == "dense"


def query_inputs(rng, b, k, q, id_range, count_hi=1000):
    """Summary rows with duplicate ids and EMPTY, counts of 0 among them, and
    queries with EMPTY, as numpy arrays."""
    items = rng.integers(-1, id_range, (b, k)).astype(np.int32)
    counts = rng.integers(0, count_hi, (b, k)).astype(np.int32)
    errors = counts // 3
    queries = rng.integers(-1, id_range + 2, (b, q)).astype(np.int32)
    return items, counts, errors, queries


@pytest.mark.parametrize("b,k,q", [(3, 16, 40), (2, 32, 300), (1, 100, 7), (2, 0, 5)])
def test_private_entry_answers_query_ref_for_every_kernel_name(rng, b, k, q):
    """On CPU tensors every kernel name (and the rule) gives the plain
    version, with no launch; an unknown name raises."""
    args = tuple(map(torch.from_numpy, query_inputs(rng, b, k, q, 24)))
    want = ref.query_ref(*args)
    before = ss_query.LAUNCHES
    for kernel in (None, *ss_query.KERNELS):
        got = ss_query._query(*args, kernel)
        for a, w in zip(got, want, strict=True):
            assert a.dtype == w.dtype and torch.equal(a, w)
    assert ss_query.LAUNCHES == before
    with pytest.raises(ValueError, match="kernel"):
        ss_query._query(*args, "sorted")


def test_small_rows_with_duplicates_match_jax(rng):
    """k 24 (a small row, the hash kernel's rule on a card), ids < 12 so
    that every id repeats, counts of 0 among them, EMPTY queries: the port's wrapper on the
    CPU against the JAX dense reference and the Pallas kernel in interpret
    mode, row by row."""
    items, counts, errors, queries = query_inputs(rng, 2, 24, 40, 12, 50)
    assert ss_query.kernel_for(2, 24, 40, torch.int32) == "hash"
    got = ss_query.query(*map(torch.from_numpy, (items, counts, errors, queries)))
    for b in range(2):
        row = tuple(jnp.asarray(a[b]) for a in (items, counts, errors, queries))
        for want in (jref.query_ref(*row), jops.query(*row, impl="pallas")):
            for g, w in zip(got, want, strict=True):
                w = np.asarray(w)
                assert g[b].numpy().dtype == w.dtype
                np.testing.assert_array_equal(g[b].numpy(), w)
