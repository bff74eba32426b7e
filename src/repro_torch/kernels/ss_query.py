"""Point queries on Hopper: the wrapper of ``csrc/ss_query.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ss_query.py:query_pallas``,
the read side of the QueryFrontend. Contract: ``kernels/ref.py:query_ref``.

What bounds it on the H100, and what the design does about it (details in
the source): at the frontend's shapes (k = 2048, a few to a few thousand
queries) a call is bound by its launch and one pass over the k ids. One
query per thread keeps its id and sums in registers while the block
streams the summary ids through shared memory as int4 broadcasts. The
Pallas kernel summed as an f32 dot, exact only below 2^24; this one sums in
the count type, bitwise equal to :func:`query_ref`. The batch and the
blocks of queries share grid.x, so a launch takes up to 2^31 - 1 blocks
(:func:`check_launch`) and the batch has no 65 535 limit.

On a CPU tensor :func:`query` computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import query_ref

#: launches of the CUDA kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0

THREADS = 128          # queries per block (kThreads in csrc/ss_query.cu)
MAX_BLOCKS = 2**31 - 1  # grid.x, which holds the batch and the blocks of queries

_FN = {torch.int32: "ss_query_i32", torch.int64: "ss_query_i64"}


@functools.cache
def _entry(dtype):
    """The C entry for one count dtype, its ctypes signature declared."""
    fn = getattr(build.load("ss_query"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def check_launch(b: int, k: int, nq: int) -> None:
    """Raise unless the kernel takes a launch of ``b`` batch entries of ``k``
    counters and ``nq`` queries: the batch and the blocks of queries share
    grid.x, so only their product is bounded."""
    if max(k, nq) > 2**31 - 1:
        raise ValueError(f"query: k and q must be below 2^31, got {k} and {nq}")
    blocks = b * -(-nq // THREADS)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"query: {b} batch entries of {nq} queries need {blocks} "
                         f"blocks, above {MAX_BLOCKS}")


def query(s_items: torch.Tensor, s_counts: torch.Tensor, s_errors: torch.Tensor,
          queries: torch.Tensor):
    """(f̂, ε, monitored) per query id: (..., k) summaries vs (..., q) queries."""
    global LAUNCHES
    _check(s_items, s_counts, s_errors, queries)
    if s_items.device.type == "cpu":
        return query_ref(s_items, s_counts, s_errors, queries)
    if s_items.device.type != "cuda":
        raise ValueError(f"query: no kernel for {s_items.device}")
    b, k, nq = s_items.shape[:-1].numel(), s_items.shape[-1], queries.shape[-1]
    check_launch(b, k, nq)
    dev, dtype = s_items.device, s_counts.dtype
    if b == 0 or nq == 0:
        f = torch.zeros(queries.shape, dtype=dtype, device=dev)
        return f, f.clone(), torch.zeros(queries.shape, dtype=torch.bool, device=dev)
    f_hat = torch.empty(queries.shape, dtype=dtype, device=dev)
    eps = torch.empty_like(f_hat)
    mon = torch.empty(queries.shape, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(dtype)(
            s_items.data_ptr(), s_counts.data_ptr(), s_errors.data_ptr(),
            queries.data_ptr(), f_hat.data_ptr(), eps.data_ptr(),
            mon.data_ptr(), b, k, nq, stream)
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"ss_query launch failed: cudaError {err}")
    return f_hat, eps, mon
