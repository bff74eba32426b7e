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
(or pair) does the whole merge, so a flush or a COMBINE round is one launch
that reads each input once and writes each output once. The window and the
k winners are ordered by block-wide LSD radix sorts that skip the digits on
which every key agrees. Sums are taken in the count type (int32 or int64)
with wrap-around: bitwise equal to the plain version.

Two paths of each kernel (:func:`path_for`): ``'smem'`` keeps the window,
its histogram, the summary and the selection in the block's shared memory,
for k ≤ :data:`SMEM_K` counters and W ≤ :data:`SMEM_W` window ids;
``'workspace'`` takes every other shape, its large buffers in a device
buffer the wrapper allocates (:func:`workspace_bytes` a batch). The launch
counts cover both; ``*_WORKSPACE_LAUNCHES`` count the workspace path's.

On a CPU tensor :func:`fused_ingest` / :func:`fused_combine` compute the
plain version; on a CUDA tensor they launch a kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_combine_ref, fused_ingest_ref

#: launches of the fused flush kernels in this process (one per wrapper launch)
INGEST_LAUNCHES = 0
#: launches of the fused COMBINE kernels in this process
COMBINE_LAUNCHES = 0
#: the part of INGEST_LAUNCHES / COMBINE_LAUNCHES that took the workspace path
INGEST_WORKSPACE_LAUNCHES = 0
COMBINE_WORKSPACE_LAUNCHES = 0

SMEM_K = 2048      # counters per summary of the shared-memory path (kSmemK)
SMEM_W = 16384     # window ids per tenant of the shared-memory path (kSmemW)
POOL_LIMIT = 2**30 - 1   # k + W of the workspace path (kMaxPool): int indices
PATHS = ("smem", "workspace")


def path_for(k: int, w: int = 0) -> str:
    """The path the wrappers take for k counters and windows of w ids (w = 0
    for COMBINE): ``'smem'`` where one block's shared memory holds the whole
    merge, else ``'workspace'``."""
    return "smem" if k <= SMEM_K and w <= SMEM_W else "workspace"


def workspace_bytes(b: int, k: int, w: int | None, dtype) -> int:
    """Bytes of the workspace path's device buffer for a batch of b: per
    tenant (``w`` ids a window) or per pair (``w`` None), 16-byte aligned,
    as ``ingest_workspace`` / ``combine_workspace`` in the source."""
    t = torch.empty((), dtype=dtype).element_size()
    per = 2 * k * t + (2 * k + 2 * (w + 1) if w is not None else 5 * k) * 4
    return b * (-(-per // 16) * 16)


_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


@functools.cache
def _entry(kernel: str, path: str, dtype):
    """The C entry of one kernel, path and count dtype, its signature declared."""
    ws = "_workspace" if path == "workspace" else ""
    fn = getattr(build.load("ss_ingest"), f"ss_fused_{kernel}{ws}_{_SUFFIX[dtype]}")
    pointers, ints = (7, 3) if kernel == "ingest" else (9, 2)
    extra = [ctypes.c_void_p, ctypes.c_size_t] if ws else []
    fn.argtypes = ([ctypes.c_void_p] * pointers + extra + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
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


def _launch(kernel, path, dev, dtype, tensors, ints, w):
    """One launch on the current stream; the workspace path first allocates
    its buffer there (uint8, 16-byte aligned by the caching allocator)."""
    global INGEST_LAUNCHES, COMBINE_LAUNCHES
    global INGEST_WORKSPACE_LAUNCHES, COMBINE_WORKSPACE_LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        pointers = [t.data_ptr() for t in tensors]
        if path == "workspace":
            size = workspace_bytes(ints[0], ints[1], w, dtype)
            ws = torch.empty(size, dtype=torch.uint8, device=dev)
            pointers += [ws.data_ptr(), size]
        err = _entry(kernel, path, dtype)(*pointers, *ints, stream)
    if kernel == "ingest":
        INGEST_LAUNCHES += 1
        INGEST_WORKSPACE_LAUNCHES += path == "workspace"
    else:
        COMBINE_LAUNCHES += 1
        COMBINE_WORKSPACE_LAUNCHES += path == "workspace"
    if err:
        raise RuntimeError(f"ss_fused_{kernel} ({path} path) launch failed: cudaError {err}")


def _check_pool(name, k, w):
    if k + w > POOL_LIMIT:
        raise ValueError(f"{name}: k + W = {k + w} above {POOL_LIMIT}, the kernels' "
                         f"int indices")


def fused_ingest(s_items: torch.Tensor, s_counts: torch.Tensor,
                 s_errors: torch.Tensor, window: torch.Tensor):
    """The flush of (B, k) summaries with their (B, W) windows: ``(items, counts, errors)``."""
    return _fused_ingest(s_items, s_counts, s_errors, window)


def _fused_ingest(s_items, s_counts, s_errors, window, path=None):
    """:func:`fused_ingest` on ``path`` (None: :func:`path_for`'s); the
    workspace path takes every shape."""
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
    path = path or path_for(k, w)
    if path not in PATHS or (path == "smem" and path_for(k, w) != "smem"):
        raise ValueError(f"fused_ingest: no {path!r} path at k = {k}, W = {w}")
    _check_pool("fused_ingest", k, w)
    out = _outputs(s_items, s_counts)
    if b == 0:
        return out
    _launch("ingest", path, dev, s_counts.dtype, (s_items, s_counts, s_errors, window, *out),
            (b, k, w), w)
    return out


def fused_combine(a_items: torch.Tensor, a_counts: torch.Tensor, a_errors: torch.Tensor,
                  b_items: torch.Tensor, b_counts: torch.Tensor, b_errors: torch.Tensor):
    """COMBINE of two batches of (B, k) summaries, pair by pair: ``(items, counts, errors)``."""
    return _fused_combine(a_items, a_counts, a_errors, b_items, b_counts, b_errors)


def _fused_combine(a_items, a_counts, a_errors, b_items, b_counts, b_errors, path=None):
    """:func:`fused_combine` on ``path`` (None: :func:`path_for`'s)."""
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
    path = path or path_for(k)
    if path not in PATHS or (path == "smem" and path_for(k) != "smem"):
        raise ValueError(f"fused_combine: no {path!r} path at k = {k}")
    _check_pool("fused_combine", k, k)
    out = _outputs(a_items, a_counts)
    if b == 0:
        return out
    _launch("combine", path, dev, a_counts.dtype, (*args, *out), (b, k), None)
    return out
