"""Match-weights on Hopper: the wrapper of ``csrc/ss_match.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ss_match.py:
match_weights_pallas``: the weight each summary slot gains from a histogram
and which histogram ids the summary monitors, the ``update`` op that the
plan's probes and the tune CLI time. Contract:
``kernels/ref.py:match_weights_ref``.

What bounds it on the H100, and what the design does about it (details in
the source): the function is an equi-join that moves ~90 KB at k = 2048,
c = 8192, so one row is bound by its launch. The Pallas kernel compared
every (summary, histogram) pair; this one is the paper's hash-table probe:
one block per batch entry inserts the summary ids into a table in shared
memory and probes each histogram id once, adding its weight with an
integer atomic. Sums are taken in the weight type (int32 or int64) with
wrap-around: bitwise equal to :func:`match_weights_ref`, duplicate ids on
either side included, where the Pallas kernel summed as an f32 dot.

On a CPU tensor :func:`match_weights` computes the plain version; on a
CUDA tensor it launches the kernel or raises, also above :data:`MAX_K`
counters (the table of one block's shared memory).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import match_weights_ref

#: launches of the CUDA kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0

MAX_K = 8192      # counters per summary (kMaxK in csrc/ss_match.cu)

_FN = {torch.int32: "ss_match_i32", torch.int64: "ss_match_i64"}


@functools.cache
def _entry(dtype):
    """The C entry for one weight dtype, its ctypes signature declared."""
    fn = getattr(build.load("ss_match"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(s_items, h_items, h_weights):
    dev = s_items.device
    for t in (s_items, h_items, h_weights):
        if t.device != dev:
            raise ValueError(f"match_weights: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("match_weights: the kernel takes contiguous tensors")
        if t.dim() < 1:
            raise ValueError("match_weights: tensors need a last axis")
    if s_items.dtype != torch.int32 or h_items.dtype != torch.int32:
        raise TypeError(f"match_weights: ids must be int32, got {s_items.dtype} "
                        f"and {h_items.dtype}")
    if h_weights.dtype not in _FN:
        raise TypeError(f"match_weights: weights must be int32 or int64, got "
                        f"{h_weights.dtype}")
    if h_weights.shape != h_items.shape:
        raise ValueError(f"match_weights: histogram shapes {tuple(h_items.shape)} "
                         f"vs {tuple(h_weights.shape)}")
    if s_items.shape[:-1] != h_items.shape[:-1]:
        raise ValueError(f"match_weights: batch dims {tuple(s_items.shape)} vs "
                         f"{tuple(h_items.shape)}")


def match_weights(s_items: torch.Tensor, h_items: torch.Tensor,
                  h_weights: torch.Tensor):
    """(add_w (..., k), matched (..., c) bool) for (..., k) vs (..., c)."""
    global LAUNCHES
    _check(s_items, h_items, h_weights)
    if s_items.device.type == "cpu":
        return match_weights_ref(s_items, h_items, h_weights)
    if s_items.device.type != "cuda":
        raise ValueError(f"match_weights: no kernel for {s_items.device}")
    b, k, c = s_items.shape[:-1].numel(), s_items.shape[-1], h_items.shape[-1]
    if k > MAX_K:
        raise ValueError(f"match_weights: the kernel takes k <= {MAX_K} counters, "
                         f"got {k}")
    if b > 2**31 - 1:
        raise ValueError(f"match_weights: at most 2^31 - 1 batch entries, got {b}")
    dev, dtype = s_items.device, h_weights.dtype
    add_w = torch.empty(s_items.shape, dtype=dtype, device=dev)
    matched = torch.empty(h_items.shape, dtype=torch.bool, device=dev)
    if b == 0:
        return add_w, matched
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(dtype)(s_items.data_ptr(), h_items.data_ptr(),
                            h_weights.data_ptr(), add_w.data_ptr(),
                            matched.data_ptr(), b, k, c, stream)
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"ss_match launch failed: cudaError {err}")
    return add_w, matched
