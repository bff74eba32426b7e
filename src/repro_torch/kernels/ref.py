"""Plain PyTorch versions of the kernels (the correctness reference).

The counterpart of ``repro.kernels.ref``, with leading batch dimensions:
summary tensors are ``(..., k)``, candidate and query tensors ``(..., c)``
with the same leading dimensions. The dense versions are what the CUDA
kernels compute and what they are held against on the card; on the CPU
the wrappers in ``ss_combine.py``/``ss_query.py``/``ss_match.py`` run them. The sorted
versions are the O((k+c)·log k) merge-join, bitwise equal to the dense
ones whenever the valid summary ids are distinct. The fused versions are
the whole flush and the whole COMBINE that ``ss_ingest.py``'s kernels
compute.

Dense sums are taken in int64 and cast back to the count type, which equals
a sum in the count type with wrap-around, as the CUDA kernels take it.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import combine
from repro_torch.core.spacesaving import Summary, update_chunk

EMPTY = -1


def match_weights_ref(s_items: torch.Tensor, h_items: torch.Tensor,
                      h_weights: torch.Tensor):
    """(add_w, matched): add_w[..., i] = Σ_j [s_i == h_j]·w_j, matched[..., j] = ∃i.

    ``s_items`` (..., k) summary ids; ``h_items``/``h_weights`` (..., c) a
    histogram. EMPTY entries on either side never match; duplicate ids on
    either side are summed. The sum is in the weight dtype with wrap-around.
    """
    eq = (s_items[..., :, None] == h_items[..., None, :])
    eq &= (s_items != EMPTY)[..., :, None]
    eq &= (h_items != EMPTY)[..., None, :]
    add_w = (eq * h_weights[..., None, :]).sum(-1).to(h_weights.dtype)
    return add_w, eq.any(-2)


def query_ref(s_items: torch.Tensor, s_counts: torch.Tensor,
              s_errors: torch.Tensor, queries: torch.Tensor):
    """(f̂, ε, monitored) for each query id against the summary."""
    eq = (s_items[..., :, None] == queries[..., None, :])
    eq &= (s_items != EMPTY)[..., :, None]
    monitored = eq.any(-2)
    f_hat = (eq * s_counts[..., :, None]).sum(-2).to(s_counts.dtype)
    eps = (eq * s_errors[..., :, None]).sum(-2).to(s_errors.dtype)
    return f_hat, eps, monitored


# ---------------------------------------------------------------------------
# Sorted merge-join formulations — O((k+c)·log k) instead of O(k·c)
# ---------------------------------------------------------------------------

def _lookup_sorted(s_items: torch.Tensor, probes: torch.Tensor):
    """For each probe id, the summary slot monitoring it (or a miss).

    Returns ``(slot, hit)``: ``slot[..., j]`` indexes ``s_items``;
    ``hit[..., j]`` is True iff probe j is a valid (non-EMPTY) id monitored
    by the summary. Requires the valid ``s_items`` entries to be distinct
    (true for any summary; EMPTY may repeat, and never matches a probe).
    """
    k = s_items.shape[-1]
    order = torch.argsort(s_items, dim=-1, stable=True)
    s_sorted = s_items.gather(-1, order)
    idx = torch.searchsorted(s_sorted, probes.contiguous(), side="left").clamp_(0, k - 1)
    hit = (s_sorted.gather(-1, idx) == probes) & (probes != EMPTY)
    return order.gather(-1, idx), hit


def match_weights_sorted(s_items: torch.Tensor, h_items: torch.Tensor,
                         h_weights: torch.Tensor):
    """Same contract as :func:`match_weights_ref`, via sort + searchsorted.

    Bitwise equal to it whenever the valid summary ids are distinct.
    """
    slot, hit = _lookup_sorted(s_items, h_items)
    add_w = torch.zeros(s_items.shape, dtype=h_weights.dtype, device=s_items.device)
    add_w.scatter_add_(-1, slot, torch.where(hit, h_weights, 0))
    return add_w, hit


def query_sorted(s_items: torch.Tensor, s_counts: torch.Tensor,
                 s_errors: torch.Tensor, queries: torch.Tensor):
    """Same contract as :func:`query_ref`, via sort + searchsorted."""
    slot, hit = _lookup_sorted(s_items, queries)
    f_hat = torch.where(hit, s_counts.gather(-1, slot), 0)
    eps = torch.where(hit, s_errors.gather(-1, slot), 0)
    return f_hat, eps, hit


# ---------------------------------------------------------------------------
# Combine-match: the matcher behind every merge (absorb-pool core)
# ---------------------------------------------------------------------------
#
#   (add_c, add_e, matched_s, matched_c) =
#       combine_match(s_items (..., k), c_items (..., c), c_counts (..., c),
#                     c_errors (..., c) | None)
#
#   add_c[i]     = Σ_j [s_i == c_j] · c_counts[j]
#   add_e[i]     = Σ_j [s_i == c_j] · c_errors[j]     (None iff c_errors is None)
#   matched_s[i] = ∃j [s_i == c_j]
#   matched_c[j] = ∃i [s_i == c_j]
#
# EMPTY ids never match. ``c_errors=None`` is the exact-histogram case
# (zero-error candidates): the errors channel is skipped.


def combine_match_ref(s_items: torch.Tensor, c_items: torch.Tensor,
                      c_counts: torch.Tensor, c_errors: torch.Tensor | None = None):
    """Dense k×c reference; duplicate ids on either side are summed."""
    eq = (s_items[..., :, None] == c_items[..., None, :])
    eq &= (s_items != EMPTY)[..., :, None]
    eq &= (c_items != EMPTY)[..., None, :]
    add_c = (eq * c_counts[..., None, :]).sum(-1).to(c_counts.dtype)
    add_e = (None if c_errors is None else
             (eq * c_errors[..., None, :]).sum(-1).to(c_errors.dtype))
    return add_c, add_e, eq.any(-1), eq.any(-2)


def combine_match_sorted(s_items: torch.Tensor, c_items: torch.Tensor,
                         c_counts: torch.Tensor, c_errors: torch.Tensor | None = None):
    """Sorted merge-join combine-match — O((k+c)·log k) instead of O(k·c).

    Bitwise equal to :func:`combine_match_ref` whenever the valid ids are
    distinct on each side (every well-formed summary and exact histogram):
    each summary slot then matches at most one candidate, so the
    scatter-add recovers the dense masked sum exactly.
    """
    slot, hit = _lookup_sorted(s_items, c_items)
    add_c = torch.zeros(s_items.shape, dtype=c_counts.dtype, device=s_items.device)
    add_c.scatter_add_(-1, slot, torch.where(hit, c_counts, 0))
    add_e = None
    if c_errors is not None:
        add_e = torch.zeros(s_items.shape, dtype=c_errors.dtype, device=s_items.device)
        add_e.scatter_add_(-1, slot, torch.where(hit, c_errors, 0))
    matched_s = torch.zeros(s_items.shape, dtype=torch.int32, device=s_items.device)
    matched_s.scatter_add_(-1, slot, hit.to(torch.int32))
    return add_c, add_e, matched_s > 0, hit


# ---------------------------------------------------------------------------
# The fused flush and COMBINE: whole merges (``csrc/ss_ingest.cu``)
# ---------------------------------------------------------------------------
#
# The bodies of the Pallas kernels ``_ingest_kernel`` and ``_combine_kernel``
# (``repro/kernels/ss_ingest.py:59-65, 100-109``): the library merge with the
# sorted matcher, on (B, k) summaries and a (B, W) window.


def fused_ingest_ref(s_items: torch.Tensor, s_counts: torch.Tensor,
                     s_errors: torch.Tensor, window: torch.Tensor):
    """``update_chunk(summary, window)`` per batch entry → (items, counts, errors)."""
    return tuple(update_chunk(Summary(s_items, s_counts, s_errors), window,
                              match_fn=combine_match_sorted))


def fused_combine_ref(a_items, a_counts, a_errors, b_items, b_counts, b_errors):
    """``combine(s1, s2)`` per batch entry → (items, counts, errors)."""
    return tuple(combine(Summary(a_items, a_counts, a_errors),
                         Summary(b_items, b_counts, b_errors),
                         match_fn=combine_match_sorted))
