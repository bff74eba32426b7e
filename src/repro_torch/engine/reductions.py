"""Reduction-strategy registry: how B tenant summaries become one.

The counterpart of ``repro.engine.reductions``. Every strategy has the
signature

    fn(stacked: Summary, groups: tuple = (), *, match_fn=None,
       pair_fn=None) -> Summary

where every leaf of ``stacked`` is (B, k) and ``groups`` are the process
groups to reduce over *in addition to* the local tenant dim, listed
INNERMOST (intra-pod) first, the JAX package's ``axis_names`` convention:
empty in a single process, where every strategy degrades to the local
tree. With that convention every strategy evaluates the same canonical
adjacent-pair COMBINE tree over the mesh-major rank order, which keeps
them bitwise-interchangeable on rank 0 (``_allgather`` gathers
outermost-first for the same reason). ``match_fn`` is the engine's
combine-match, driving every COMBINE the strategy makes; ``pair_fn``
replaces the batched COMBINE of a local tree round
(``core.combine.reduce_summaries``).

Built-ins mirror the paper's study (``core/parallel.py``):

  * ``local``        — log₂(B) rounds of batched COMBINE on the device.
  * ``butterfly``    — local reduce, then a recursive-doubling COMBINE
                       allreduce over each group in turn.
  * ``allgather``    — local reduce, then all-gather + tree-combine (the
                       flat-MPI analogue).
  * ``hierarchical`` — local reduce, then intra-pod butterfly followed by
                       one cross-pod butterfly (the hybrid MPI/OpenMP
                       winner).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.combine import reduce_summaries
from repro_torch.core.parallel import (allgather_combine, butterfly_combine,
                                       hierarchical_combine)
from repro_torch.core.spacesaving import Summary

Reduction = Callable[..., Summary]

_REGISTRY: Dict[str, Reduction] = {}


def register_reduction(name: str, fn: Reduction, *, overwrite: bool = False) -> None:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"reduction {name!r} already registered")
    _REGISTRY[name] = fn


def get_reduction(name: str) -> Reduction:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown reduction {name!r}; have "
                       f"{sorted(_REGISTRY)}") from None


def reduction_names():
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

def _local(stacked: Summary, groups=(), *, match_fn=None, pair_fn=None) -> Summary:
    return reduce_summaries(stacked, match_fn=match_fn, pair_fn=pair_fn)


def _butterfly(stacked: Summary, groups=(), *, match_fn=None, pair_fn=None) -> Summary:
    s = reduce_summaries(stacked, match_fn=match_fn, pair_fn=pair_fn)
    for group in groups:
        s = butterfly_combine(s, group, match_fn=match_fn)
    return s


def _allgather(stacked: Summary, groups=(), *, match_fn=None, pair_fn=None) -> Summary:
    s = reduce_summaries(stacked, match_fn=match_fn, pair_fn=pair_fn)
    if groups:
        # reversing the innermost-first convention gathers outermost-first,
        # the mesh-major rank order the canonical COMBINE tree expects
        s = allgather_combine(s, tuple(reversed(groups)), match_fn=match_fn)
    return s


def _hierarchical(stacked: Summary, groups=(), *, match_fn=None, pair_fn=None) -> Summary:
    s = reduce_summaries(stacked, match_fn=match_fn, pair_fn=pair_fn)
    if groups:
        outer = groups[1] if len(groups) > 1 else None
        s = hierarchical_combine(s, groups[0], outer, match_fn=match_fn)
    return s


register_reduction("local", _local)
register_reduction("butterfly", _butterfly)
register_reduction("allgather", _allgather)
register_reduction("hierarchical", _hierarchical)
