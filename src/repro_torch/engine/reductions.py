"""Reduction-strategy registry: how B tenant summaries become one.

The counterpart of ``repro.engine.reductions``. A strategy has the signature

    fn(stacked: Summary, *, match_fn=None, pair_fn=None) -> Summary

where every leaf of ``stacked`` is (B, k). ``match_fn`` is the engine's
combine-match and ``pair_fn`` replaces the batched COMBINE of a tree round
(``core.combine.reduce_summaries``). Only ``local`` is registered: the mesh
strategies (butterfly, allgather, hierarchical) come with the port of
``core/parallel.py`` to ``torch.distributed``.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.combine import reduce_summaries
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


def _local(stacked: Summary, *, match_fn=None, pair_fn=None) -> Summary:
    """log₂(B) rounds of batched adjacent-pair COMBINE on the device."""
    return reduce_summaries(stacked, match_fn=match_fn, pair_fn=pair_fn)


register_reduction("local", _local)
