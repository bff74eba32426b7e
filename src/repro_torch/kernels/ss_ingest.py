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
that reads each input once and writes each output once. The shared-memory
kernels sort no ids. The flush builds the window's histogram in a
shared-memory hash table (:func:`table_slots`) under a hash keyed by a salt
drawn afresh for each launch, so that no window chosen in advance can pile
its ids onto one probe chain (the result does not depend on the table's
layout), looks each summary id up there, radix-selects the k-th largest
count of the pool, gives ties to the summary slots first and then to the
lowest ids, and sorts only the k winners, each as one key, by a bitonic
network. The COMBINE loads both summaries in 16-byte loads, puts s2's ids
into such a table (each with its lowest slot), looks each s1 id up there,
radix-selects the k-th largest count of the pool [s1 | s2's unmatched
slots], gives ties to the lowest pool ranks by one block scan, and sorts
only the k winners, one key each (count, then pool rank), by the same
network (:func:`combine_smem_bytes`). The other paths sort the window (or
s2's slots by id) and the winners by block-wide LSD radix sorts that skip
the digits on which every key agrees. Sums are taken in the count type
(int32 or int64) with wrap-around: bitwise equal to the plain version.

Three paths of each kernel, picked by shape (:func:`path_for`): ``'smem'``
keeps the window's histogram (or s2's table), the summary and the
selection in one block's shared memory (:func:`smem_bytes`,
:func:`combine_smem_bytes`), for k ≤ :data:`SMEM_K`
counters and W ≤ :data:`SMEM_W` window ids; ``'cluster'`` runs a tenant
(or pair) on a thread-block cluster of C blocks (:func:`cluster_for`),
each holding a 1/C slice of the window and of the summary in its shared
memory (:func:`cluster_smem_bytes`), the blocks exchanging through
distributed shared memory, where some C in :data:`CLUSTER_SIZES` holds the
shape and the card runs the batch's clusters in one round or W is above
:data:`SMEM_W`; ``'workspace'`` takes the rest, its large buffers in a
device buffer the wrapper allocates (:func:`workspace_bytes` a batch). The
launch counts cover every path; ``*_CLUSTER_LAUNCHES`` and
``*_WORKSPACE_LAUNCHES`` count the cluster and workspace paths'.

On a CPU tensor :func:`fused_ingest` / :func:`fused_combine` compute the
plain version; on a CUDA tensor they launch a kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import random

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_combine_ref, fused_ingest_ref

#: launches of the fused flush kernels in this process (one per wrapper launch)
INGEST_LAUNCHES = 0
#: launches of the fused COMBINE kernels in this process
COMBINE_LAUNCHES = 0
#: the part of INGEST_LAUNCHES / COMBINE_LAUNCHES that took the cluster path
INGEST_CLUSTER_LAUNCHES = 0
COMBINE_CLUSTER_LAUNCHES = 0
#: the part of INGEST_LAUNCHES / COMBINE_LAUNCHES that took the workspace path
INGEST_WORKSPACE_LAUNCHES = 0
COMBINE_WORKSPACE_LAUNCHES = 0

SMEM_K = 2048      # counters per summary of the shared-memory path (kSmemK)
SMEM_W = 16384     # window ids per tenant of the shared-memory path (kSmemW)
POOL_LIMIT = 2**30 - 1   # k + W of the workspace path (kMaxPool): int indices
PATHS = ("smem", "cluster", "workspace")
CLUSTER_SIZES = (2, 4, 8, 16)   # blocks a cluster (16: the card's non-portable size)
SMEM_LIMIT = 232448      # shared memory one block may opt in to (kMaxSmem)
_CLUSTER_SCRATCH = 8240  # sizeof(ClusterScratch) in the source
_COUNTERS = 256 * 32 * 2  # the sort's 16-bit (digit, warp) counters
#: static shared memory of the shared-memory flush: Scratch and FlushScratch
#: in the source, 16-byte aligned each (ptxas: 2336 bytes smem)
SMEM_STATIC = 2336
#: static shared memory of the shared-memory COMBINE: Scratch, 16-byte aligned
COMBINE_SMEM_STATIC = 2064
#: draws the salt of each shared-memory launch (seeded from the operating
#: system's entropy source)
_SALTS = random.Random()


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def table_slots(w: int) -> int:
    """Slots of the shared-memory flush's hash table for windows of w ids,
    as ``table_slots`` in the source: 1.5 w rounded up to a multiple of 8,
    at least 8, so that it holds every distinct id of a window at a load of
    at most 2/3 and always keeps a free slot."""
    return 8 if w < 5 else (w + ((w + 1) >> 1) + 7) & ~7


def join_slots(k: int) -> int:
    """Slots of the shared-memory COMBINE's hash table for s2's k ids, as
    ``join_slots`` in the source: 4 k rounded up to a multiple of 8, a load
    of at most 1/4, so that its longest probe chain, which the block waits
    for, stays short."""
    return (4 * k + 7) & ~7


@functools.cache
def smem_bytes(k: int, w: int, dtype) -> int:
    """Dynamic shared memory of the shared-memory flush for k counters of
    ``dtype`` and windows of w ids, as ``ingest_smem`` in the source: the
    winners' sort buffers (a power of two ≥ max(k, 64) slots of 12 bytes at
    int32, an 8-byte key and a 4-byte id, and of 16 at int64), the
    summary's counts, errors and items, and the table's int32 keys and
    16-bit weights, each region 16-byte aligned.
    With :data:`SMEM_STATIC` it fits :data:`SMEM_LIMIT` at every k ≤
    :data:`SMEM_K` and W ≤ :data:`SMEM_W`."""
    t = torch.empty((), dtype=dtype).element_size()
    sort_slots = 1 << (max(k, 64) - 1).bit_length()
    return (_a16(sort_slots * (12 if t == 4 else 16)) + 2 * _a16(k * t) + _a16(k * 4)
            + table_slots(w) * 6)


@functools.cache
def combine_smem_bytes(k: int, dtype) -> int:
    """Dynamic shared memory of the shared-memory COMBINE for pairs of k
    counters of ``dtype``, as ``combine_smem`` in the source: the winners'
    sort buffer (a power of two ≥ max(k, 64) keys of 8 bytes at int32 and
    16 at int64), the pool's 2k counts, errors and items, and the hash
    table's :func:`join_slots` int32 keys and as many s2 slot numbers, each
    region 16-byte aligned. With :data:`COMBINE_SMEM_STATIC` it fits
    :data:`SMEM_LIMIT` at every k ≤ :data:`SMEM_K`."""
    t = torch.empty((), dtype=dtype).element_size()
    sort_slots = 1 << (max(k, 64) - 1).bit_length()
    return (_a16(sort_slots * (8 if t == 4 else 16)) + 2 * _a16(2 * k * t) + _a16(2 * k * 4)
            + join_slots(k) * 8)


@functools.cache
def cluster_smem_bytes(k: int, w: int | None, c: int, dtype) -> int:
    """Shared memory of one block of the cluster path, all of it dynamic, as
    ``ingest_cluster_smem`` (``w`` window ids a tenant) or
    ``combine_cluster_smem`` (``w`` None) in the source: the cluster
    scratch, the sort's counters, a winner buffer of ks = ⌈k / C⌉ entries
    (12 or 24 B each), and the larger of a second winner buffer and the
    merge's buffers: the block's slices of ks slots (counts and errors,
    items; COMBINE: both summaries and two (id, slot) buffers) and of
    S = ⌈W / C⌉ window ids (two S + 1 buffers), each region 16-byte
    aligned."""
    t = torch.empty((), dtype=dtype).element_size()
    ks = -(-k // c)
    win = _a16(ks * (12 if t == 4 else 24))
    if w is None:
        merge = 4 * _a16(ks * t) + 2 * _a16(ks * 8) + 2 * _a16(ks * 4)
    else:
        s = -(-w // c) if w > 0 else 1
        merge = 2 * _a16(ks * t) + _a16(ks * 4) + 2 * _a16((s + 1) * 4)
    return _CLUSTER_SCRATCH + _COUNTERS + win + max(merge, win)


@functools.cache
def cluster_fits(k: int, w: int, c: int, dtype=torch.int32) -> bool:
    """Whether a cluster of c blocks holds k counters and windows of w ids
    at count type ``dtype``: slices of at most :data:`SMEM_W` (the sort's
    16-bit counters and register ranks) within :data:`SMEM_LIMIT` bytes
    (w = 0 is also the COMBINE of k-counter summaries)."""
    if -(-k // c) > SMEM_W or -(-w // c) > SMEM_W:
        return False
    need = cluster_smem_bytes(k, w, c, dtype)
    if w == 0:
        need = max(need, cluster_smem_bytes(k, None, c, dtype))
    return need <= SMEM_LIMIT


def clusters_at_once(k: int, w: int = 0, dtype=torch.int32, device=None) -> dict[int, int]:
    """How many clusters of each size in :data:`CLUSTER_SIZES` that holds the
    shape (:func:`cluster_fits`) the card runs at once, for k counters of
    ``dtype`` and windows of w ids (w = 0: the smaller of the flush's and
    the COMBINE's): ``cudaOccupancyMaxActiveClusters`` of the cluster
    kernels at that shape (:func:`cluster_occupancy`) on ``device`` (None:
    the current card), asked once a card and shape."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _clusters_at_once(index, k, w, dtype)


@functools.cache
def _clusters_at_once(index: int, k: int, w: int, dtype) -> dict[int, int]:
    kernels = ("ingest", "combine") if w == 0 else ("ingest",)
    with torch.cuda.device(index):
        return {c: min(cluster_occupancy(kernel, dtype, k, w, c) for kernel in kernels)
                for c in CLUSTER_SIZES if cluster_fits(k, w, c, dtype)}


def cluster_for(k: int, w: int = 0, b: int = 1, dtype=torch.int32,
                at_once: dict[int, int] | None = None) -> int | None:
    """Blocks a cluster for b tenants (or pairs) of k counters of ``dtype``
    and windows of w ids (w = 0 for COMBINE): the smallest size in
    :data:`CLUSTER_SIZES` that holds the shape, raised to the largest size
    at which the card still runs all b clusters at once (``at_once``, the
    clusters of each size it runs at once; None: the current card's,
    :func:`clusters_at_once`), so that few tenants spread over the card;
    to 16 only where a tenant's k + W is above 4 · :data:`SMEM_W`, below
    which a cluster's own syncs cost more than its 8 more blocks save
    (``tools/cluster_sizes.py``). None where no cluster holds the shape."""
    fits = [c for c in CLUSTER_SIZES if cluster_fits(k, w, c, dtype)]
    if not fits:
        return None
    at_once = clusters_at_once(k, w, dtype) if at_once is None else at_once
    return max([fits[0]] + [c for c in fits if b <= at_once[c]
                            and (c <= 8 or k + w > 4 * SMEM_W)])


def path_for(k: int, w: int = 0, b: int = 1, dtype=torch.int32,
             at_once: dict[int, int] | None = None) -> str:
    """The path the wrappers take for b tenants of k counters of ``dtype`` and
    windows of w ids (w = 0 for COMBINE): ``'smem'`` where one block's
    shared memory holds the whole merge; else ``'cluster'`` where a cluster
    holds it (:func:`cluster_for`, ``at_once`` as there) and either the
    card runs all b clusters at once or the window is above :data:`SMEM_W`
    (where the workspace kernel's one block a tenant sorts out of L2); else
    ``'workspace'``, which one block a tenant runs faster when the clusters
    would take several rounds of the card."""
    if k <= SMEM_K and w <= SMEM_W:
        return "smem"
    c = cluster_for(k, w, b, dtype, at_once)
    if c is None:
        return "workspace"
    at_once = clusters_at_once(k, w, dtype) if at_once is None else at_once
    return "cluster" if b <= at_once[c] or w > SMEM_W else "workspace"


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
    name = f"ss_fused_{kernel}{'' if path == 'smem' else '_' + path}_{_SUFFIX[dtype]}"
    fn = getattr(build.load("ss_ingest"), name)
    pointers, ints = (7, 3) if kernel == "ingest" else (9, 2)
    extra = [ctypes.c_void_p, ctypes.c_size_t] if ws else []
    ints += path == "cluster"   # the cluster's size
    salt = [ctypes.c_uint32] if path == "smem" else []
    fn.argtypes = ([ctypes.c_void_p] * pointers + extra + [ctypes.c_int] * ints + salt
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cluster_occupancy(kernel: str, dtype, k: int, w: int, c: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel of ``kernel``
    (``'ingest'`` or ``'combine'``) at k, w (ignored for COMBINE) and
    clusters of c blocks: how many such clusters the card holds at once."""
    fn = build.load("ss_ingest").ss_fused_cluster_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(int(kernel == "combine"), int(dtype == torch.int64), k, w, c, ctypes.byref(out))
    if err:
        raise RuntimeError(f"cluster occupancy of ss_fused_{kernel} at k {k}, W {w}, "
                           f"C {c}: cudaError {err}")
    return out.value


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
    its buffer there (uint8, 16-byte aligned by the caching allocator), a
    shared-memory kernel gets a fresh salt for its table's hash."""
    global INGEST_LAUNCHES, COMBINE_LAUNCHES
    global INGEST_CLUSTER_LAUNCHES, COMBINE_CLUSTER_LAUNCHES
    global INGEST_WORKSPACE_LAUNCHES, COMBINE_WORKSPACE_LAUNCHES
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        pointers = [t.data_ptr() for t in tensors]
        if path == "workspace":
            size = workspace_bytes(ints[0], ints[1], w, dtype)
            ws = torch.empty(size, dtype=torch.uint8, device=dev)
            pointers += [ws.data_ptr(), size]
        if path == "smem":
            ints = (*ints, _SALTS.getrandbits(32))
        err = _entry(kernel, path, dtype)(*pointers, *ints, stream)
    if kernel == "ingest":
        INGEST_LAUNCHES += 1
        INGEST_CLUSTER_LAUNCHES += path == "cluster"
        INGEST_WORKSPACE_LAUNCHES += path == "workspace"
    else:
        COMBINE_LAUNCHES += 1
        COMBINE_CLUSTER_LAUNCHES += path == "cluster"
        COMBINE_WORKSPACE_LAUNCHES += path == "workspace"
    if err:
        raise RuntimeError(f"ss_fused_{kernel} ({path} path) launch failed: cudaError {err}")


def _check_pool(name, k, w):
    if k + w > POOL_LIMIT:
        raise ValueError(f"{name}: k + W = {k + w} above {POOL_LIMIT}, the kernels' "
                         f"int indices")


def _resolve(name, dev, b, k, w, dtype, path, c):
    """The path and cluster size of one launch: ``path`` None takes
    :func:`path_for`'s, ``c`` None :func:`cluster_for`'s; a forced path or
    size that does not hold the shape raises."""
    at_once = None if k <= SMEM_K and w <= SMEM_W else clusters_at_once(k, w, dtype, dev)
    rule = path_for(k, w, b, dtype, at_once)
    path = path or rule
    if path not in PATHS or (path == "smem" and rule != "smem"):
        raise ValueError(f"{name}: no {path!r} path at k = {k}, W = {w}")
    if path != "cluster":
        return path, None
    c = c or cluster_for(k, w, b, dtype, at_once)
    if c not in CLUSTER_SIZES or not cluster_fits(k, w, c, dtype):
        raise ValueError(f"{name}: no cluster of {c} blocks holds k = {k}, W = {w}")
    return path, c


def fused_ingest(s_items: torch.Tensor, s_counts: torch.Tensor,
                 s_errors: torch.Tensor, window: torch.Tensor):
    """The flush of (B, k) summaries with their (B, W) windows: ``(items, counts, errors)``."""
    return _fused_ingest(s_items, s_counts, s_errors, window)


def _fused_ingest(s_items, s_counts, s_errors, window, path=None, c=None):
    """:func:`fused_ingest` on ``path`` (None: :func:`path_for`'s) with
    clusters of ``c`` blocks on the cluster path (None:
    :func:`cluster_for`'s); the workspace path takes every shape."""
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
    path, c = _resolve("fused_ingest", dev, b, k, w, s_counts.dtype, path, c)
    _check_pool("fused_ingest", k, w)
    out = _outputs(s_items, s_counts)
    if b == 0:
        return out
    _launch("ingest", path, dev, s_counts.dtype, (s_items, s_counts, s_errors, window, *out),
            (b, k, w) + ((c,) if c else ()), w)
    return out


def fused_combine(a_items: torch.Tensor, a_counts: torch.Tensor, a_errors: torch.Tensor,
                  b_items: torch.Tensor, b_counts: torch.Tensor, b_errors: torch.Tensor):
    """COMBINE of two batches of (B, k) summaries, pair by pair: ``(items, counts, errors)``."""
    return _fused_combine(a_items, a_counts, a_errors, b_items, b_counts, b_errors)


def _fused_combine(a_items, a_counts, a_errors, b_items, b_counts, b_errors, path=None,
                   c=None):
    """:func:`fused_combine` on ``path`` (None: :func:`path_for`'s) with
    clusters of ``c`` blocks on the cluster path (None:
    :func:`cluster_for`'s)."""
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
    path, c = _resolve("fused_combine", dev, b, k, 0, a_counts.dtype, path, c)
    _check_pool("fused_combine", k, k)
    out = _outputs(a_items, a_counts)
    if b == 0:
        return out
    _launch("combine", path, dev, a_counts.dtype, (*args, *out), (b, k) + ((c,) if c else ()),
            None)
    return out
