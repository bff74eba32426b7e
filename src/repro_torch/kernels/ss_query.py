"""Point queries on Hopper: the wrapper of ``csrc/ss_query.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ss_query.py:query_pallas``,
the read side of the QueryFrontend. Contract: ``kernels/ref.py:query_ref``.

What bounds it on the H100, and what the design does about it (details in
the source): the function is an equi-join of a row's k summary ids with its
q query ids, one insert per valid summary id and one probe per query. At
the frontend's shapes (B 1, k 2048, a few to a few thousand queries) that
is far below a launch's latency; at many small rows it is the bytes. Two
kernels, chosen from the shape (:func:`kernel_for`), return the same bits:

* ``'hash'`` (the rule where the table fits one block, :func:`hash_fits`):
  the block builds a table of the row's distinct ids in shared memory, the
  sums added with integer atomics, and every query probes it once. This
  module owns the table's bytes (:func:`table_bytes`; its slots are
  ``ss_combine.table_slots``).
* ``'dense'`` (above the table's limit): one query per thread against the
  row staged through shared memory, k compares a query.

This module owns the launch geometry of both (:func:`block_geometry`) and
passes it to the C entries, which only refuse what they cannot launch.

The Pallas kernel summed as an f32 dot, exact only below 2^24; these sum in
the count type with wrap-around, bitwise equal to :func:`query_ref`,
duplicate summary ids included. The batch and its slices of queries share
grid.x, so a launch takes up to 2^31 - 1 blocks (:func:`check_launch`) and
the batch has no 65 535 limit.

On a CPU tensor :func:`query` computes the plain version; on a CUDA tensor
it launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import query_ref
# the same table as the combine-match hash join: its slots, and all of one
# block's shared memory on the H100
from repro_torch.kernels.ss_combine import SMEM_BYTES, table_slots

#: launches of the CUDA kernels in this process (the wrapper adds one per launch)
LAUNCHES = 0

KERNELS = ("hash", "dense")
HASH_MIN_QUERIES = 1024  # a hash block takes at least max(k, this) queries
DENSE_THREADS = 128     # queries a dense block, one a thread (at most kDenseMaxThreads)
MAX_BLOCKS = 2**31 - 1  # grid.x, which holds the batch and its slices of queries

_FN = {torch.int32: "i32", torch.int64: "i64"}


def table_bytes(k: int, dtype: torch.dtype) -> int:
    """Shared memory of the table: per slot an int32 id and two sums of the
    count type (counts and errors)."""
    return table_slots(k) * (4 + 2 * dtype.itemsize)


def hash_fits(k: int, dtype: torch.dtype) -> bool:
    """Whether the hash kernel's table for ``k`` summary ids fits one block
    (k <= 8192 at int32, k <= 4096 at int64)."""
    return table_bytes(k, dtype) <= SMEM_BYTES


def block_geometry(kernel: str, k: int) -> tuple[int, int]:
    """(threads, queries) of a block of ``kernel`` for rows of ``k`` ids.
    A hash block's threads grow with k from 128 to 1024, and it takes at
    least max(k, 1024) queries, so that building its table costs no more
    than its probes; a dense block takes one query a thread."""
    if kernel == "hash":
        threads = min(1024, max(128, 1 << max(0, k - 1).bit_length()))
        return threads, max(k, HASH_MIN_QUERIES)
    return DENSE_THREADS, DENSE_THREADS


def kernel_for(b: int, k: int, nq: int, dtype: torch.dtype) -> str:
    """The kernel the shape rule takes: ``'hash'`` where its table fits
    (:func:`hash_fits`), else ``'dense'``. (``b`` and ``nq`` do not move the
    rule; the launch's blocks are bounded by :func:`check_launch`.)"""
    return "hash" if hash_fits(k, dtype) else "dense"


def check_launch(b: int, k: int, nq: int, dtype: torch.dtype = torch.int32,
                 kernel: str | None = None) -> str:
    """Raise unless ``kernel`` (default: :func:`kernel_for`'s) takes a launch
    of ``b`` batch entries of ``k`` counters and ``nq`` queries; return the
    kernel. The batch and the slices of queries share grid.x, so only the
    number of blocks is bounded; ``'hash'`` also needs its table to fit."""
    if max(k, nq) > 2**31 - 1:
        raise ValueError(f"query: k and q must be below 2^31, got {k} and {nq}")
    kernel = kernel or kernel_for(b, k, nq, dtype)
    if kernel not in KERNELS:
        raise ValueError(f"query: kernel {kernel!r} not in {KERNELS}")
    if kernel == "hash" and not hash_fits(k, dtype):
        raise ValueError(f"query: the hash table of k = {k} ({dtype}) needs "
                         f"{table_bytes(k, dtype)} bytes of shared memory, above "
                         f"{SMEM_BYTES}")
    n = b * -(-nq // block_geometry(kernel, k)[1])
    if n > MAX_BLOCKS:
        raise ValueError(f"query: {b} batch entries of {nq} queries need {n} "
                         f"blocks of the {kernel} kernel, above {MAX_BLOCKS}")
    return kernel


def _launch_args(kernel: str, k: int, dtype: torch.dtype) -> tuple:
    """The C entry's arguments after (batch, k, nq): the table's log2 slots
    and bytes and the block's threads and queries for ``'hash'``; the
    block's threads for ``'dense'``."""
    threads, per_block = block_geometry(kernel, k)
    if kernel == "hash":
        return table_slots(k).bit_length() - 1, table_bytes(k, dtype), threads, per_block
    return (threads,)


@functools.cache
def _entry(kernel, dtype):
    """The C entry of one kernel and count dtype, its ctypes signature declared."""
    name = {"dense": "ss_query", "hash": "ss_query_hash"}[kernel]
    fn = getattr(build.load("ss_query"), f"{name}_{_FN[dtype]}")
    # batch, k, nq, and threads (dense) or log_slots, smem, threads, slice (hash)
    ints = {"dense": 4, "hash": 7}[kernel]
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _allow_table(dtype, device_index):
    """Let the hash kernel take up to SMEM_BYTES of shared memory on a device
    (once per count dtype and device)."""
    fn = getattr(build.load("ss_query"), f"ss_query_hash_setup_{_FN[dtype]}")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    with torch.cuda.device(device_index):
        err = fn(SMEM_BYTES)
    if err:
        raise RuntimeError(f"ss_query hash setup failed: cudaError {err}")


def _check(s_items, s_counts, s_errors, queries):
    dev = s_items.device
    for t in (s_items, s_counts, s_errors, queries):
        if t.device != dev:
            raise ValueError(f"query: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("query: the kernel takes contiguous tensors")
        if t.dim() < 1:
            raise ValueError("query: tensors need a last axis")
    if s_items.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError(f"query: ids must be int32, got {s_items.dtype} and "
                        f"{queries.dtype}")
    if s_counts.dtype not in _FN or s_errors.dtype != s_counts.dtype:
        raise TypeError(f"query: counts/errors must be one of int32/int64, got "
                        f"{s_counts.dtype} and {s_errors.dtype}")
    if s_counts.shape != s_items.shape or s_errors.shape != s_items.shape:
        raise ValueError("query: summary channels differ in shape")
    if s_items.shape[:-1] != queries.shape[:-1]:
        raise ValueError(f"query: batch dims {tuple(s_items.shape)} vs "
                         f"{tuple(queries.shape)}")


def query(s_items: torch.Tensor, s_counts: torch.Tensor, s_errors: torch.Tensor,
          queries: torch.Tensor):
    """(f̂, ε, monitored) per query id: (..., k) summaries vs (..., q) queries."""
    return _query(s_items, s_counts, s_errors, queries, None)


def _query(s_items, s_counts, s_errors, queries, kernel):
    """:func:`query` with the CUDA kernel named, ``'hash'`` or ``'dense'``,
    or None for :func:`kernel_for`'s rule. Forcing one serves to measure
    and check it at a shape the rule gives another; ``'hash'`` raises where
    its table does not fit."""
    global LAUNCHES
    _check(s_items, s_counts, s_errors, queries)
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"query: kernel {kernel!r} not in {KERNELS}")
    if s_items.device.type == "cpu":
        return query_ref(s_items, s_counts, s_errors, queries)
    if s_items.device.type != "cuda":
        raise ValueError(f"query: no kernel for {s_items.device}")
    b, k, nq = s_items.shape[:-1].numel(), s_items.shape[-1], queries.shape[-1]
    dev, dtype = s_items.device, s_counts.dtype
    kernel = check_launch(b, k, nq, dtype, kernel)
    if b == 0 or nq == 0:
        f = torch.zeros(queries.shape, dtype=dtype, device=dev)
        return f, f.clone(), torch.zeros(queries.shape, dtype=torch.bool, device=dev)
    f_hat = torch.empty(queries.shape, dtype=dtype, device=dev)
    eps = torch.empty_like(f_hat)
    mon = torch.empty(queries.shape, dtype=torch.bool, device=dev)
    if kernel == "hash":
        _allow_table(dtype, dev.index)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(kernel, dtype)(
            s_items.data_ptr(), s_counts.data_ptr(), s_errors.data_ptr(),
            queries.data_ptr(), f_hat.data_ptr(), eps.data_ptr(),
            mon.data_ptr(), b, k, nq, *_launch_args(kernel, k, dtype), stream)
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"ss_query {kernel} launch failed: cudaError {err}")
    return f_hat, eps, mon
