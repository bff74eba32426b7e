"""Fused flush and fused COMBINE on Hopper: the wrapper of ``csrc/ss_ingest.cu``.

Replaces the Pallas TPU kernels ``repro/kernels/ss_ingest.py:
fused_ingest_pallas`` (the whole deferred flush of every tenant in one
launch) and ``fused_combine_pallas`` (one round of the COMBINE tree in one
launch). Contracts: :func:`kernels.ref.fused_ingest_ref` and
:func:`kernels.ref.fused_combine_ref`, the bodies of the Pallas kernels
(``update_chunk`` / ``combine`` with the sorted matcher).

What bounds it on the H100, and what the design does about it (details in
the source): the function moves little, 7.3 MB for a flush of 64 tenants at
k = 2048 and W = 16 384 (2.2 µs at 3.35 TB/s), while its plain version is
~40 PyTorch ops, each a launch and a round trip of the window or the
(k + W) pool through device memory. One block of 1024 threads per tenant
(or pair) keeps the window, its histogram, the summary and the selection
in shared memory, so a flush or a COMBINE round is one launch that reads
each input once and writes each output once. The window and the k winners
are ordered by block-wide LSD radix sorts that skip the digits on which
every key agrees. Sums are taken in the count type (int32 or int64) with
wrap-around: bitwise equal to the plain version.

On a CPU tensor :func:`fused_ingest` / :func:`fused_combine` compute the
plain version; on a CUDA tensor they launch the kernel or raise, also for a
shape above :data:`MAX_K` counters or :data:`MAX_W` window ids (one block's
shared memory at int64 counts). :func:`fits` says where they take a shape.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_combine_ref, fused_ingest_ref

#: launches of the fused flush kernel in this process (one per wrapper launch)
INGEST_LAUNCHES = 0
#: launches of the fused COMBINE kernel in this process
COMBINE_LAUNCHES = 0

MAX_K = 2048      # counters per summary (kMaxK in csrc/ss_ingest.cu)
MAX_W = 16384     # window ids per tenant (kMaxW in csrc/ss_ingest.cu)


def fits(k: int, w: int = 0) -> bool:
    """Whether the kernels take summaries of k counters and windows of w ids.

    ``'auto'`` routes to the fused kernels only where this holds
    (``kernels.ops.resolve_window_impl``); an explicit ``'fused'`` above
    the limits raises. The rule lasts until the kernels lift their limits.
    """
    return k <= MAX_K and w <= MAX_W

_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


@functools.cache
def _entry(kernel: str, dtype):
    """The C entry of one kernel for one count dtype, its signature declared."""
    fn = getattr(build.load("ss_ingest"), f"ss_fused_{kernel}_{_SUFFIX[dtype]}")
    pointers, ints = (7, 3) if kernel == "ingest" else (9, 2)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_summary(name, items, counts, errors, batch=None):
    """One (B, k) summary: device, dtype, shape and contiguity."""
    if items.dim() != 2:
        raise ValueError(f"{name}: summaries are (B, k), got {tuple(items.shape)}")
    if items.shape[-1] < 1:
        raise ValueError(f"{name}: a summary needs at least one counter")
    if items.dtype != torch.int32:
        raise TypeError(f"{name}: items must be int32, got {items.dtype}")
    if counts.dtype not in _SUFFIX or errors.dtype != counts.dtype:
        raise TypeError(f"{name}: counts and errors must both be int32 or int64, "
                        f"got {counts.dtype} and {errors.dtype}")
    for t in (items, counts, errors):
        if t.shape != items.shape:
            raise ValueError(f"{name}: summary shapes {tuple(items.shape)} vs "
                             f"{tuple(t.shape)}")
    if batch is not None and items.shape != batch.shape:
        raise ValueError(f"{name}: summaries {tuple(batch.shape)} vs "
                         f"{tuple(items.shape)}")


def _check_tensors(name, tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev}")
    return dev


def _outputs(items, counts):
    return (torch.empty_like(items), torch.empty_like(counts), torch.empty_like(counts))


def _launch(kernel, dev, dtype, pointers, ints):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        return _entry(kernel, dtype)(*pointers, *ints, stream)


def fused_ingest(s_items: torch.Tensor, s_counts: torch.Tensor,
                 s_errors: torch.Tensor, window: torch.Tensor):
    """The flush of (B, k) summaries with their (B, W) windows: ``(items, counts, errors)``."""
    global INGEST_LAUNCHES
    _check_summary("fused_ingest", s_items, s_counts, s_errors)
    if window.dim() != 2 or window.shape[0] != s_items.shape[0]:
        raise ValueError(f"fused_ingest: window {tuple(window.shape)} is not "
                         f"(B, W) for summaries {tuple(s_items.shape)}")
    if window.dtype != torch.int32:
        raise TypeError(f"fused_ingest: window ids must be int32, got {window.dtype}")
    dev = _check_tensors("fused_ingest", (s_items, s_counts, s_errors, window))
    if dev.type == "cpu":
        return fused_ingest_ref(s_items, s_counts, s_errors, window)
    (b, k), w = s_items.shape, window.shape[-1]
    if not fits(k, w):
        raise ValueError(f"fused_ingest: the kernel takes k <= {MAX_K} counters and "
                         f"W <= {MAX_W} window ids, got k = {k}, W = {w}")
    out = _outputs(s_items, s_counts)
    if b == 0:
        return out
    err = _launch("ingest", dev, s_counts.dtype,
                  [t.data_ptr() for t in (s_items, s_counts, s_errors, window, *out)],
                  (b, k, w))
    INGEST_LAUNCHES += 1
    if err:
        raise RuntimeError(f"ss_fused_ingest launch failed: cudaError {err}")
    return out


def fused_combine(a_items: torch.Tensor, a_counts: torch.Tensor, a_errors: torch.Tensor,
                  b_items: torch.Tensor, b_counts: torch.Tensor, b_errors: torch.Tensor):
    """COMBINE of two batches of (B, k) summaries, pair by pair: ``(items, counts, errors)``."""
    global COMBINE_LAUNCHES
    _check_summary("fused_combine", a_items, a_counts, a_errors)
    _check_summary("fused_combine", b_items, b_counts, b_errors, batch=a_items)
    if b_counts.dtype != a_counts.dtype:
        raise TypeError(f"fused_combine: count dtypes {a_counts.dtype} and "
                        f"{b_counts.dtype} differ")
    args = (a_items, a_counts, a_errors, b_items, b_counts, b_errors)
    dev = _check_tensors("fused_combine", args)
    if dev.type == "cpu":
        return fused_combine_ref(*args)
    b, k = a_items.shape
    if not fits(k):
        raise ValueError(f"fused_combine: the kernel takes k <= {MAX_K} counters, "
                         f"got k = {k}")
    out = _outputs(a_items, a_counts)
    if b == 0:
        return out
    err = _launch("combine", dev, a_counts.dtype,
                  [t.data_ptr() for t in (*args, *out)], (b, k))
    COMBINE_LAUNCHES += 1
    if err:
        raise RuntimeError(f"ss_fused_combine launch failed: cudaError {err}")
    return out
