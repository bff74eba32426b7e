"""Parallel Space Saving (the paper's Algorithm 1) over ``torch.distributed``.

The counterpart of ``repro.core.parallel``. Three reduction strategies over
process groups, mirroring the paper's study; each is called by every rank
of its group(s) with that rank's summary:

  * :func:`butterfly_combine` — log₂(p) rounds of a paired exchange
    (``dist.batch_isend_irecv`` with partner ``rank ^ 2^i``) + COMBINE over
    ONE group: the message-passing analogue of the paper's MPI reduction.
  * :func:`allgather_combine` — all-gather the summaries (over several
    groups at once) then tree-combine locally: the *flat MPI* analogue;
    moves p·k entries to every rank.
  * :func:`hierarchical_combine` — butterfly over the intra-pod group
    first, then over the cross-pod group: the *hybrid MPI/OpenMP*
    analogue, one cross-pod round instead of log₂(p).

A group stands where the JAX package named a mesh axis: a mesh dimension's
group (``DeviceMesh.get_group(name)``, :func:`axis_groups`) holds the ranks
that differ only along that dimension, ranked by their index along it.

All three evaluate the SAME canonical adjacent-pair COMBINE tree on rank 0
of the group(s) (see ``reduce_summaries``), so any strategy over any
topology gives rank 0 the bitwise-identical global summary. As in the JAX
package, each rank combines ``combine(own, other)``, so under the
butterfly the other ranks hold summaries of the same stream that may break
ties otherwise; ``StreamRuntime.merged`` hands every rank rank 0's.

Collectives run on the tensors' device: the groups' backend must move them
(``gloo`` for CPU tensors, ``nccl`` for CUDA ones; ``launch.mesh``).

The consumer-facing entry points (:func:`parallel_spacesaving`,
:func:`frequent_items`) are owned by the StreamRuntime (``repro_torch.runtime``)
and re-exported here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.combine import combine, reduce_summaries
from repro_torch.core.spacesaving import (Summary, init_summary, pad_stream,
                                          spacesaving_chunked)


# ---------------------------------------------------------------------------
# Block decomposition (lines 1–2 of Algorithm 1)
# ---------------------------------------------------------------------------

def block_decompose(stream, workers: int, multiple: int = 1) -> torch.Tensor:
    """Split a (N,) stream into (workers, per) EMPTY-padded blocks.

    ``per`` is ⌈N/workers⌉ rounded up to ``multiple`` (a chunk size), so
    every worker block feeds a chunked update path without further padding.
    This is THE canonical decomposition: the single-process engine's
    tenants, the StreamRuntime's shard×lane workers, and the paper's MPI
    ranks all index the same blocks. A tensor keeps its device; anything
    else becomes a CPU tensor.
    """
    if not isinstance(stream, torch.Tensor):
        stream = torch.from_numpy(np.ascontiguousarray(stream))
    n = stream.shape[-1]
    per = -(-n // workers)
    per = -(-per // multiple) * multiple
    if per == 0:     # empty stream → (workers, 0)
        return stream.reshape(workers, 0)
    return pad_stream(stream, per * workers).reshape(workers, per)


# ---------------------------------------------------------------------------
# Group reductions (every rank of the group calls them)
# ---------------------------------------------------------------------------

def axis_groups(mesh, names) -> tuple:
    """The process groups of ``mesh``'s dimensions ``names``, in that order.

    Raises a ValueError naming a dimension the mesh does not have (or a
    mesh that is missing) instead of a failure inside a collective.
    """
    names = tuple(names)
    if not names:
        return ()
    if mesh is None:
        raise ValueError(f"mesh dimensions {names} do not exist: there is no "
                         f"mesh (a single-shard engine reduces locally)")
    dims = tuple(mesh.mesh_dim_names or ())
    for name in names:
        if name not in dims:
            raise ValueError(f"mesh dimension {name!r} does not exist in this "
                             f"mesh (dimensions {dims})")
    return tuple(mesh.get_group(name) for name in names)


def _require_group(group, role: str):
    """A group this rank belongs to, or a ValueError naming the role."""
    if not isinstance(group, dist.ProcessGroup) or dist.get_rank(group) < 0:
        raise ValueError(
            f"hierarchical_combine: the {role} group {group!r} does not exist "
            f"for this rank. Pass a process group that holds this rank (a mesh "
            f"dimension's, see axis_groups), or outer=None for a single-pod "
            f"reduction (equivalent to butterfly_combine over the intra-pod "
            f"group).")
    return group


def _exchange(s: Summary, peer: int, group) -> Summary:
    """Send ``s`` to global rank ``peer`` and receive its summary, paired."""
    own = [a.contiguous() for a in s]
    other = [torch.empty_like(a) for a in own]
    ops = ([dist.P2POp(dist.isend, a, peer, group) for a in own]
           + [dist.P2POp(dist.irecv, b, peer, group) for b in other])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return Summary(*other)


def butterfly_combine(s: Summary, group, *, match_fn=None) -> Summary:
    """Recursive-doubling COMBINE allreduce over ``group``.

    Round i exchanges summaries between group ranks differing in bit i and
    merges ``combine(own, other)``; after log₂(p) rounds rank 0 holds the
    canonical tree's summary. Each round moves one k-counter summary per
    rank. Recursive doubling needs a power-of-two group; on any other size
    this falls back to :func:`allgather_combine`. ``match_fn``
    (``kernels.ops.combine_match`` contract) selects the merge kernel.
    """
    p = dist.get_world_size(group)
    if p & (p - 1):
        return allgather_combine(s, (group,), match_fn=match_fn)
    me = dist.get_rank(group)
    for i in range(p.bit_length() - 1):
        other = _exchange(s, dist.get_global_rank(group, me ^ (1 << i)), group)
        s = combine(s, other, match_fn=match_fn)
    return s


def _all_gather(a: torch.Tensor, group) -> torch.Tensor:
    """(group size,) + a.shape: every rank's ``a`` in group-rank order."""
    a = a.contiguous()
    out = [torch.empty_like(a) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, a, group=group)
    return torch.stack(out)


def allgather_combine(s: Summary, groups, *, match_fn=None) -> Summary:
    """Flat reduction: gather every rank's summary, tree-combine locally.

    ``groups`` are listed outermost first; the gather runs innermost first,
    each adding a leading dim, so the stack is in mesh-major rank order.
    """
    stacked = s
    for group in reversed(tuple(groups)):
        stacked = Summary(*(_all_gather(a, group) for a in stacked))
    flat = Summary(*(a.reshape(-1, a.shape[-1]) for a in stacked))
    return reduce_summaries(flat, match_fn=match_fn)


def hierarchical_combine(s: Summary, inner, outer, *, match_fn=None) -> Summary:
    """Two-level reduction: intra-pod butterfly, then cross-pod butterfly.

    The paper's hybrid MPI/OpenMP finding: communication over the slow
    (cross-pod) group drops from log₂(p_total) rounds to log₂(n_pods).
    Both groups are checked up front; single-pod callers pass
    ``outer=None``.
    """
    _require_group(inner, "intra-pod")
    if outer is not None:
        _require_group(outer, "cross-pod")
    s = butterfly_combine(s, inner, match_fn=match_fn)
    if outer is not None:
        s = butterfly_combine(s, outer, match_fn=match_fn)
    return s


# Strategy selection by name lives in the engine's reduction registry
# (repro_torch.engine.reductions), which wraps the three combinators above.


# ---------------------------------------------------------------------------
# Algorithm 1 — the local pass over logical workers, in one process
# ---------------------------------------------------------------------------

def local_summaries(stream, *, p: int, k: int, chunk_size: int = 1024,
                    device="cuda") -> Summary:
    """Block decomposition + per-worker Space Saving (lines 2–5 of Alg. 1).

    The stream is padded and reshaped to (p, n/p) on ``device``; each
    logical worker runs the chunked Space Saving over its block, as one
    batched call over the p workers.
    """
    blocks = block_decompose(stream, p, chunk_size).to(device=device, dtype=torch.int32)
    init = init_summary(k, device=blocks.device, batch=(p,))
    return spacesaving_chunked(init, blocks, chunk_size=chunk_size)


def parallel_spacesaving(stream, *, k: int, p: int, chunk_size: int = 1024,
                         kernel: str = "auto", device="cuda") -> Summary:
    """Algorithm 1: local Space Saving per block, then ParallelReduction.

    The StreamRuntime one-shot API (``repro_torch.runtime.parallel_spacesaving``).
    """
    from repro_torch.runtime import parallel_spacesaving as _run
    return _run(stream, k=k, p=p, chunk_size=chunk_size, kernel=kernel, device=device)


def frequent_items(stream, *, k_majority: int, counters: int | None = None,
                   p: int = 1, chunk_size: int = 1024, device="cuda"):
    """End-to-end k-majority query: (items, f̂, candidate, guaranteed).

    The StreamRuntime one-shot API (``repro_torch.runtime.frequent_items``).
    """
    from repro_torch.runtime import frequent_items as _run
    return _run(stream, k_majority=k_majority, counters=counters, p=p,
                chunk_size=chunk_size, device=device)
