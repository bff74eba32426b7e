"""Combine-match on Hopper: the wrapper of ``csrc/ss_combine.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ss_combine.py:
combine_match_pallas``, the matcher inside every ``absorb_pool`` (every
engine flush and every COMBINE round). Contract: ``kernels/ref.py``.

What bounds it on the H100, and what the design does about it (details in
the source): the dense formulation does k·c id compares per batch entry
against a few MB of input, so it is bound by compare issue rate. One
summary row per thread keeps its id and sums in registers while the block
streams the candidate ids through shared memory as int4 broadcasts; counts
and errors are read from global memory only on a match. Sums are taken in
the count type (int32 or int64) with wrap-around: bitwise equal to
:func:`combine_match_ref`, duplicate candidate ids included.

On a CPU tensor :func:`combine_match` computes the plain version; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import combine_match_ref

#: launches of the CUDA kernel in this process (the wrapper adds one per launch)
LAUNCHES = 0

_FN = {torch.int32: "ss_combine_match_i32", torch.int64: "ss_combine_match_i64"}


@functools.cache
def _entry(dtype):
    """The C entry for one count dtype, its ctypes signature declared."""
    fn = getattr(build.load("ss_combine"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(s_items, c_items, c_counts, c_errors):
    dev = s_items.device
    tensors = [s_items, c_items, c_counts] + ([] if c_errors is None else [c_errors])
    if s_items.dim() < 1 or c_items.dim() < 1:
        raise ValueError("combine_match: ids need a last (counter) axis")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"combine_match: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("combine_match: the kernel takes contiguous tensors")
    if s_items.dtype != torch.int32 or c_items.dtype != torch.int32:
        raise TypeError(f"combine_match: ids must be int32, got "
                        f"{s_items.dtype} and {c_items.dtype}")
    if c_counts.dtype not in _FN:
        raise TypeError(f"combine_match: counts must be int32 or int64, got "
                        f"{c_counts.dtype}")
    if c_errors is not None and c_errors.dtype != c_counts.dtype:
        raise TypeError(f"combine_match: errors {c_errors.dtype} != counts "
                        f"{c_counts.dtype}")
    if s_items.shape[:-1] != c_items.shape[:-1]:
        raise ValueError(f"combine_match: batch dims {tuple(s_items.shape)} vs "
                         f"{tuple(c_items.shape)}")
    for t in tensors[2:]:
        if t.shape != c_items.shape:
            raise ValueError(f"combine_match: candidate shapes "
                             f"{tuple(c_items.shape)} vs {tuple(t.shape)}")


def combine_match(s_items: torch.Tensor, c_items: torch.Tensor,
                  c_counts: torch.Tensor, c_errors: torch.Tensor | None = None):
    """(add_c, add_e | None, matched_s, matched_c) for (..., k) vs (..., c)."""
    global LAUNCHES
    _check(s_items, c_items, c_counts, c_errors)
    if s_items.device.type == "cpu":
        return combine_match_ref(s_items, c_items, c_counts, c_errors)
    if s_items.device.type != "cuda":
        raise ValueError(f"combine_match: no kernel for {s_items.device}")
    b, k, c = s_items.shape[:-1].numel(), s_items.shape[-1], c_items.shape[-1]
    if b > 65535:
        raise ValueError(f"combine_match: at most 65535 batch entries, got {b}")
    dev, dtype = s_items.device, c_counts.dtype
    matched_c = torch.zeros(c_items.shape, dtype=torch.bool, device=dev)
    if b == 0 or k == 0:
        add_c = torch.zeros(s_items.shape, dtype=dtype, device=dev)
        return (add_c, None if c_errors is None else add_c.clone(),
                torch.zeros(s_items.shape, dtype=torch.bool, device=dev), matched_c)
    add_c = torch.empty(s_items.shape, dtype=dtype, device=dev)
    add_e = None if c_errors is None else torch.empty_like(add_c)
    matched_s = torch.empty(s_items.shape, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(dtype)(
            s_items.data_ptr(), c_items.data_ptr(), c_counts.data_ptr(),
            None if c_errors is None else c_errors.data_ptr(),
            add_c.data_ptr(), None if add_e is None else add_e.data_ptr(),
            matched_s.data_ptr(), matched_c.data_ptr(), b, k, c, stream)
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"ss_combine launch failed: cudaError {err}")
    return add_c, add_e, matched_s, matched_c
