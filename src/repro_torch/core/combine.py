"""The paper's COMBINE operator (Algorithm 2) and the reduction tree.

The counterpart of ``repro.core.combine``. COMBINE merges two Space Saving
summaries into one that is a valid summary of the concatenation of their
streams (Cafaro, Pulimeno, Tempesta, Inf. Sci. 2016):

    m1/m2 = min frequency of S1/S2   (0 if the summary has free counters)
    x in both:      f̂ = f̂1 + f̂2         ε = ε1 + ε2
    x only in S1:   f̂ = f̂1 + m2          ε = ε1 + m2
    x only in S2:   f̂ = f̂2 + m1          ε = ε2 + m1
    keep the k largest counters.

It is the shared ``absorb_pool`` primitive with the candidates' m₂; every
function takes leading batch dims, so one tree round is one batched call.
"""
from __future__ import annotations

import torch

from repro_torch.core.spacesaving import EMPTY, Summary, absorb_pool, min_frequency


def combine(s1: Summary, s2: Summary, *, match_fn=None) -> Summary:
    """Merge two (batches of) summaries with the same number of counters k."""
    if s1.k != s2.k:
        raise ValueError(f"combine: k differs ({s1.k} vs {s2.k})")
    return absorb_pool(s1, s2.items, s2.counts, s2.errors,
                       m2=min_frequency(s2), match_fn=match_fn)


def empty_like(s: Summary) -> Summary:
    """The COMBINE identity (all counters free)."""
    return Summary(items=torch.full_like(s.items, EMPTY),
                   counts=torch.zeros_like(s.counts),
                   errors=torch.zeros_like(s.errors))


def _pad_pow2(stacked: Summary) -> Summary:
    """Pad the leading axis of a stack to a power of two with empty summaries."""
    p = stacked.items.shape[0]
    pow2 = 1 << (p - 1).bit_length()
    if pow2 == p:
        return stacked
    extra = empty_like(Summary(*(a[:1].repeat((pow2 - p,) + (1,) * (a.dim() - 1))
                                 for a in stacked)))
    return Summary(*(torch.cat([a, e], dim=0) for a, e in zip(stacked, extra)))


def reduce_summaries(stacked: Summary, *, match_fn=None, pair_fn=None) -> Summary:
    """Reduce a stack of P summaries (leading axis) to one in log₂(P) rounds.

    Each round merges ADJACENT pairs (2i, 2i+1) with one batched COMBINE.
    P is padded to a power of two with empty summaries (the identity). The
    adjacent pairing is the exact COMBINE tree of the JAX package, which
    bitwise equality needs. ``pair_fn`` replaces the batched COMBINE of a
    round: a ``(Summary, Summary) -> Summary`` callable on (P/2, k) stacks
    that must return the same bits.
    """
    if pair_fn is None:
        def pair_fn(a, b):
            return combine(a, b, match_fn=match_fn)
    cur = _pad_pow2(stacked)
    while cur.items.shape[0] > 1:
        half = cur.items.shape[0] // 2
        pairs = [a.reshape((half, 2) + a.shape[1:]) for a in cur]
        cur = pair_fn(Summary(*(a[:, 0] for a in pairs)),
                      Summary(*(a[:, 1] for a in pairs)))
    return Summary(*(a[0] for a in cur))
