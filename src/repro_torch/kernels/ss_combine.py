"""Combine-match on Hopper: the wrapper of ``csrc/ss_combine.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ss_combine.py:
combine_match_pallas``, the matcher inside every ``absorb_pool`` (every
engine flush and every COMBINE round). Contract: ``kernels/ref.py``.

What bounds it on the H100, and what the design does about it (details in
the source): the function is an equi-join, bound by the bytes it reads and
writes once; the Pallas kernel compared every (summary, candidate) pair.
The rule is a hash join, ``combine_hash_kernel``: one block per batch entry
inserts the summary ids into a table in shared memory and probes each
candidate id once, adding its count and error with integer atomics and
flagging the id as matched. This module owns the table's size
(:func:`table_slots`, :func:`table_bytes`) and passes it to the launch.
Where the table does not fit into one block's shared memory
(:func:`hash_fits`, a function of k, the count type and the errors
channel), the wrapper launches ``combine_dense_kernel``, the dense compare,
instead: a rule decided from the shape before the launch
(:func:`kernel_for`), and both kernels return the same bits. Both take the
batch on grid.x, up to 2^31 - 1 blocks. Sums are taken in the count type
(int32 or int64) with wrap-around: bitwise equal to
:func:`combine_match_ref`, duplicate ids on either side included.
``ss_match.py`` launches the same kernels (:func:`launch`) with no errors
channel.

On a CPU tensor :func:`combine_match` computes the plain version; on a CUDA
tensor it launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import combine_match_ref

#: launches in this process, either kernel (the wrapper adds one per launch)
LAUNCHES = 0
#: of those, launches of the dense kernel
DENSE_LAUNCHES = 0

#: shared memory one block may take on the H100 (227 KB), all of it the table's
SMEM_BYTES = 232_448
MIN_SLOTS = 64          # table slots at the least
DENSE_THREADS = 256     # summary rows per block of the dense kernel (kDenseThreads)
MAX_BLOCKS = 2**31 - 1  # grid.x

KERNELS = ("hash", "dense")
_FN = {torch.int32: "i32", torch.int64: "i64"}


def table_slots(k: int) -> int:
    """Slots of the hash table for ``k`` summary ids: the least power of two
    at or above 2k (load <= 1/2), and at least 64."""
    return max(MIN_SLOTS, 1 << max(0, 2 * k - 1).bit_length())


def table_bytes(k: int, dtype: torch.dtype, errors: bool) -> int:
    """Shared memory of the table: per slot an int32 id, a one-byte matched
    flag, and an accumulator of the count type per channel."""
    channels = 2 if errors else 1
    return table_slots(k) * (4 + 1 + channels * dtype.itemsize)


def hash_fits(k: int, dtype: torch.dtype, errors: bool) -> bool:
    """Whether the hash kernel's table for ``k`` summary ids fits one block."""
    return table_bytes(k, dtype, errors) <= SMEM_BYTES


def kernel_for(b: int, k: int, c: int, dtype: torch.dtype, errors: bool) -> str:
    """The kernel a launch of this shape takes: ``'hash'`` where its table
    fits (:func:`hash_fits`), else ``'dense'``. Raises where neither does:
    the batch is on grid.x (one block per entry, or one per 256 summary
    rows of an entry), so only the number of blocks is bounded."""
    if max(k, c) > 2**31 - 1:
        raise ValueError(f"combine_match: k and c must be below 2^31, got {k} and {c}")
    kernel = "hash" if hash_fits(k, dtype, errors) else "dense"
    blocks = b if kernel == "hash" else b * -(-k // DENSE_THREADS)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"combine_match: {b} batch entries of {k} counters need "
                         f"{blocks} blocks, above {MAX_BLOCKS}")
    return kernel


@functools.cache
def _entry(kernel, dtype):
    """The C entry of one kernel and count dtype, its ctypes signature declared."""
    fn = getattr(build.load("ss_combine"), f"ss_combine_{kernel}_{_FN[dtype]}")
    ints = 5 if kernel == "hash" else 3     # batch, k, c (, log_slots, smem)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _allow_table(dtype, device_index):
    """Let the hash kernel take up to SMEM_BYTES of shared memory on a device
    (once per count dtype and device)."""
    fn = getattr(build.load("ss_combine"), f"ss_combine_hash_setup_{_FN[dtype]}")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    with torch.cuda.device(device_index):
        err = fn(SMEM_BYTES)
    if err:
        raise RuntimeError(f"ss_combine hash setup failed: cudaError {err}")


def launch(kernel: str, s_items, c_items, c_counts, c_errors):
    """One launch of ``kernel`` (``'hash'`` or ``'dense'``) on contiguous CUDA
    tensors of at least one batch entry, checked as :func:`combine_match`
    checks them: (add_c, add_e | None, matched_s, matched_c). Raises if the
    launch fails. The calling wrapper counts the launch."""
    b, k, c = s_items.shape[:-1].numel(), s_items.shape[-1], c_items.shape[-1]
    dev, dtype, errors = s_items.device, c_counts.dtype, c_errors is not None
    add_c = torch.empty(s_items.shape, dtype=dtype, device=dev)
    add_e = torch.empty_like(add_c) if errors else None
    matched_s = torch.empty(s_items.shape, dtype=torch.bool, device=dev)
    # the hash kernel writes every matched_c entry; the dense one only hits
    matched_c = (torch.zeros if kernel == "dense" else torch.empty)(
        c_items.shape, dtype=torch.bool, device=dev)
    table = ()
    if kernel == "hash":
        _allow_table(dtype, dev.index)
        table = (table_slots(k).bit_length() - 1, table_bytes(k, dtype, errors))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(kernel, dtype)(
            s_items.data_ptr(), c_items.data_ptr(), c_counts.data_ptr(),
            c_errors.data_ptr() if errors else None,
            add_c.data_ptr(), add_e.data_ptr() if errors else None,
            matched_s.data_ptr(), matched_c.data_ptr(), b, k, c, *table, stream)
    if err:
        raise RuntimeError(f"ss_combine {kernel} launch failed: cudaError {err}")
    return add_c, add_e, matched_s, matched_c


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
    return _combine_match(s_items, c_items, c_counts, c_errors, None)


def _combine_match(s_items, c_items, c_counts, c_errors, kernel):
    """:func:`combine_match` with the CUDA kernel named: ``'hash'`` or
    ``'dense'``, or None for :func:`kernel_for`'s rule. Forcing one serves to
    measure the other at the same shape; ``'hash'`` raises where its table
    does not fit."""
    global LAUNCHES, DENSE_LAUNCHES
    _check(s_items, c_items, c_counts, c_errors)
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"combine_match: kernel {kernel!r} not in {KERNELS}")
    if s_items.device.type == "cpu":
        return combine_match_ref(s_items, c_items, c_counts, c_errors)
    if s_items.device.type != "cuda":
        raise ValueError(f"combine_match: no kernel for {s_items.device}")
    b, k, c = s_items.shape[:-1].numel(), s_items.shape[-1], c_items.shape[-1]
    dtype, errors = c_counts.dtype, c_errors is not None
    rule = kernel_for(b, k, c, dtype, errors)
    if kernel == "hash" and rule != "hash":
        raise ValueError(f"combine_match: the hash table of k = {k} ({dtype}, errors "
                         f"{errors}) needs {table_bytes(k, dtype, errors)} bytes of "
                         f"shared memory, above {SMEM_BYTES}")
    kernel = kernel or rule
    if b == 0:
        add_c = torch.zeros(s_items.shape, dtype=dtype, device=s_items.device)
        return (add_c, add_c.clone() if errors else None, add_c.bool(),
                torch.zeros(c_items.shape, dtype=torch.bool, device=s_items.device))
    out = launch(kernel, s_items, c_items, c_counts, c_errors)
    LAUNCHES += 1
    DENSE_LAUNCHES += kernel == "dense"
    return out
