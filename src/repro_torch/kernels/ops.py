"""Dispatch over the Space Saving kernels — the counterpart of ``repro.kernels.ops``.

``impl`` names and their JAX counterparts:

  * ``'cuda'``   ↔ ``'pallas'`` — the hand-written Hopper kernels
                   (``ss_combine.py``, ``ss_query.py``); CUDA tensors only:
                   a CPU tensor raises, nothing falls back.
  * ``'torch'``  ↔ ``'jnp'``    — the dense plain version (``ref.py``).
  * ``'sorted'`` ↔ ``'sorted'`` — sort + searchsorted merge-join; needs
                   distinct valid summary ids (true of every summary).
  * ``'auto'``   — ``'cuda'`` for CUDA tensors; on the CPU ``'sorted'`` from
                   ``SORTED_MIN_K`` counters up and ``'torch'`` below, the
                   static rule of the JAX package's plan (``static_impl``).
  * ``'fused'``  ↔ ``'fused'``  — the whole-merge kernels (``ss_ingest.py``):
                   a real dispatch target only at the window-level ops
                   (``ingest_window``, ``combine_summaries``), where a CUDA
                   tensor launches the kernel and a CPU tensor computes its
                   plain version; at ``combine_match``/``query`` it degrades
                   to ``'sorted'``, the matcher inside the kernels. ``'auto'``
                   never resolves to it: only a measured plan may.

Every impl returns the same bits. All functions take leading batch dims.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ss_combine, ss_ingest, ss_query

IMPLS = ("auto", "torch", "sorted", "cuda", "fused")
SORTED_MIN_K = 256      # dense ↔ sorted crossover off the card (repro.plan.SORTED_MIN_K)


def resolve_impl(impl: str, k: int, device) -> str:
    """Collapse ``'auto'`` for ``k`` counters on ``device``; validate the name."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        if torch.device(device).type == "cuda":
            return "cuda"
        return "sorted" if k >= SORTED_MIN_K else "torch"
    return impl


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: impl='cuda' needs CUDA tensors, got {t.device}")


def combine_match(s_items: torch.Tensor, c_items: torch.Tensor,
                  c_counts: torch.Tensor, c_errors: torch.Tensor | None = None, *,
                  impl: str = "auto"):
    """The matcher behind every merge; contract in ``kernels/ref.py``.

    Returns (add_c (..., k), add_e (..., k) | None, matched_s (..., k),
    matched_c (..., c)).
    """
    impl = resolve_impl(impl, s_items.shape[-1], s_items.device)
    if impl in ("sorted", "fused"):
        return _ref.combine_match_sorted(s_items, c_items, c_counts, c_errors)
    if impl == "torch":
        return _ref.combine_match_ref(s_items, c_items, c_counts, c_errors)
    _cuda_only("combine_match", s_items)
    return ss_combine.combine_match(
        s_items.contiguous(), c_items.contiguous(), c_counts.contiguous(),
        None if c_errors is None else c_errors.contiguous())


def query(s_items, s_counts, s_errors, queries, *, impl: str = "auto"):
    """(f̂, ε, monitored) per query; contract in ``kernels/ref.py:query_ref``."""
    impl = resolve_impl(impl, s_items.shape[-1], s_items.device)
    if impl in ("sorted", "fused"):
        return _ref.query_sorted(s_items, s_counts, s_errors, queries)
    if impl == "torch":
        return _ref.query_ref(s_items, s_counts, s_errors, queries)
    _cuda_only("query", s_items)
    return ss_query.query(s_items.contiguous(), s_counts.contiguous(),
                          s_errors.contiguous(), queries.contiguous())


# -- window-level ops ---------------------------------------------------------

def _flat(fn, *channels):
    """``fn`` on (B, n) views of (..., n) channels; outputs reshaped back."""
    lead = channels[0].shape[:-1]
    out = fn(*(a.reshape(-1, a.shape[-1]).contiguous() for a in channels))
    return tuple(o.reshape(lead + o.shape[-1:]) for o in out)


def ingest_window(s_items: torch.Tensor, s_counts: torch.Tensor,
                  s_errors: torch.Tensor, window: torch.Tensor, *,
                  impl: str = "auto"):
    """Flush a pending window into batched summaries — the engine's merge.

    ``s_*`` are (..., k) summaries and ``window`` the (..., W) pending
    stream (EMPTY-padded). Computes ``update_chunk(summary, window)``: with
    ``'fused'`` as one ``ss_ingest`` launch over all tenants, else with
    ``combine_match`` under ``impl``, one batched call over all tenants.
    Returns the updated ``(items, counts, errors)``.
    """
    from repro_torch.core.spacesaving import Summary, update_chunk
    impl = resolve_impl(impl, s_items.shape[-1], s_items.device)
    if impl == "fused":
        return _flat(ss_ingest.fused_ingest, s_items, s_counts, s_errors, window)
    match = functools.partial(combine_match, impl=impl)
    return tuple(update_chunk(Summary(s_items, s_counts, s_errors), window,
                              match_fn=match))


def combine_summaries(s1_items, s1_counts, s1_errors, s2_items, s2_counts,
                      s2_errors, *, impl: str = "auto"):
    """Batched pairwise COMBINE — one reduction-tree round.

    All six channels are (..., k). Returns the merged ``(items, counts,
    errors)`` of ``core.combine.combine``: with ``'fused'`` as one
    ``ss_ingest`` launch over all pairs, else with ``combine_match`` under
    ``impl``.
    """
    from repro_torch.core.combine import combine
    from repro_torch.core.spacesaving import Summary
    impl = resolve_impl(impl, s1_items.shape[-1], s1_items.device)
    if impl == "fused":
        return _flat(ss_ingest.fused_combine, s1_items, s1_counts, s1_errors,
                     s2_items, s2_counts, s2_errors)
    match = functools.partial(combine_match, impl=impl)
    return tuple(combine(Summary(s1_items, s1_counts, s1_errors),
                         Summary(s2_items, s2_counts, s2_errors),
                         match_fn=match))
