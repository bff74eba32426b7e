"""Dispatch over the Space Saving kernels — the counterpart of ``repro.kernels.ops``.

``impl`` names and their JAX counterparts:

  * ``'cuda'``   ↔ ``'pallas'`` — the hand-written Hopper kernels
                   (``ss_combine.py``, ``ss_query.py``, ``ss_match.py``);
                   CUDA tensors only: a CPU tensor raises, nothing falls back.
  * ``'torch'``  ↔ ``'jnp'``    — the dense plain version (``ref.py``).
  * ``'sorted'`` ↔ ``'sorted'`` — sort + searchsorted merge-join; needs
                   distinct valid summary ids (true of every summary).
  * ``'auto'``   — resolved through the plan of the tensor's device
                   (:func:`resolve_impl`): a measured plan picks the impl
                   probed fastest there; without one, the static rule of
                   ``plan.static_impl`` — ``'cuda'`` for CUDA tensors, and
                   on the CPU ``'sorted'`` from ``plan.SORTED_MIN_K`` counters up
                   and ``'torch'`` below (``match_weights``: ``'torch'``).
  * ``'fused'``  ↔ ``'fused'``  — the whole-merge kernels (``ss_ingest.py``):
                   a real dispatch target only at the window-level ops
                   (``ingest_window``, ``combine_summaries``), where a CUDA
                   tensor launches the kernel and a CPU tensor computes its
                   plain version; at ``match_weights``/``combine_match``/
                   ``query`` it degrades to ``'sorted'``, the matcher inside
                   the kernels. Only a measured plan may resolve ``'auto'``
                   to it, at every shape (the kernels take them all).

Every impl returns the same bits. All functions take leading batch dims.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ss_combine, ss_ingest, ss_match, ss_query
from repro_torch.plan import service as _svc

IMPLS = ("auto", "torch", "sorted", "cuda", "fused")

# -- memoized plan resolution -------------------------------------------------
# Every 'auto' dispatch resolves, and an uncached resolution costs a stat of
# the plan cache and a table lookup. The memo holds the collapsed answer and
# is invalidated by the PlanService generation, which bumps on
# install()/clear(): a plan file swapped under a running process is picked
# up at the next clear(), as in the JAX package.

_resolve_cache: dict = {}      # (op, k, device) -> impl
_resolve_gen: int | None = None


def resolve_impl(op: str, k: int, device) -> str:
    """Collapse ``'auto'`` for ``op`` at counter budget ``k`` on ``device``.

    Memoizing wrapper over :func:`repro_torch.plan.resolve_impl`, the one
    auto-routing point of the port.
    """
    global _resolve_gen
    gen = _svc.generation()
    if gen != _resolve_gen:
        _resolve_cache.clear()
        _resolve_gen = gen
    key = (op, int(k), str(device))
    impl = _resolve_cache.get(key)
    if impl is None:
        impl = _resolve_cache[key] = _svc.resolve_impl(op, k, device)
    return impl


def _impl(impl: str, op: str, k: int, device) -> str:
    """Validate an impl name and collapse ``'auto'`` through the plan."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    return resolve_impl(op, k, device) if impl == "auto" else impl


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: impl='cuda' needs CUDA tensors, got {t.device}")


def match_weights(s_items: torch.Tensor, h_items: torch.Tensor,
                  h_weights: torch.Tensor, *, impl: str = "auto"):
    """Weight each summary slot gains from a histogram; contract in
    ``kernels/ref.py:match_weights_ref``.

    Returns (add_w (..., k), matched (..., c)). ``'auto'`` resolves
    through the plan's ``"update"`` table.
    """
    impl = _impl(impl, "update", s_items.shape[-1], s_items.device)
    if impl in ("sorted", "fused"):
        return _ref.match_weights_sorted(s_items, h_items, h_weights)
    if impl == "torch":
        return _ref.match_weights_ref(s_items, h_items, h_weights)
    _cuda_only("match_weights", s_items)
    return ss_match.match_weights(s_items.contiguous(), h_items.contiguous(),
                                  h_weights.contiguous())


def combine_match(s_items: torch.Tensor, c_items: torch.Tensor,
                  c_counts: torch.Tensor, c_errors: torch.Tensor | None = None, *,
                  impl: str = "auto"):
    """The matcher behind every merge; contract in ``kernels/ref.py``.

    Returns (add_c (..., k), add_e (..., k) | None, matched_s (..., k),
    matched_c (..., c)). ``'auto'`` resolves through the plan's
    ``"combine"`` table.
    """
    impl = _impl(impl, "combine", s_items.shape[-1], s_items.device)
    if impl in ("sorted", "fused"):
        return _ref.combine_match_sorted(s_items, c_items, c_counts, c_errors)
    if impl == "torch":
        return _ref.combine_match_ref(s_items, c_items, c_counts, c_errors)
    _cuda_only("combine_match", s_items)
    return ss_combine.combine_match(
        s_items.contiguous(), c_items.contiguous(), c_counts.contiguous(),
        None if c_errors is None else c_errors.contiguous())


def query(s_items, s_counts, s_errors, queries, *, impl: str = "auto"):
    """(f̂, ε, monitored) per query; contract in ``kernels/ref.py:query_ref``.

    ``'auto'`` resolves through the plan's ``"query"`` table.
    """
    impl = _impl(impl, "query", s_items.shape[-1], s_items.device)
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
    Returns the updated ``(items, counts, errors)``. ``'auto'`` resolves
    through the plan's ``"flush"`` table.
    """
    from repro_torch.core.spacesaving import Summary, update_chunk
    impl = _impl(impl, "flush", s_items.shape[-1], s_items.device)
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
    ``impl``. ``'auto'`` resolves through the plan's ``"combine"`` table.
    """
    from repro_torch.core.combine import combine
    from repro_torch.core.spacesaving import Summary
    impl = _impl(impl, "combine", s1_items.shape[-1], s1_items.device)
    if impl == "fused":
        return _flat(ss_ingest.fused_combine, s1_items, s1_counts, s1_errors,
                     s2_items, s2_counts, s2_errors)
    match = functools.partial(combine_match, impl=impl)
    return tuple(combine(Summary(s1_items, s1_counts, s1_errors),
                         Summary(s2_items, s2_counts, s2_errors),
                         match_fn=match))
