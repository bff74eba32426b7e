"""Space Saving summaries in PyTorch — the counterpart of ``repro.core.spacesaving``.

A summary is three fixed-shape tensors with leading batch dimensions
written out, so that B tenants are one batched call and not a loop:

  items  (..., k) int32        monitored item ids, ``EMPTY`` (= -1) marks a free slot
  counts (..., k) count dtype  estimated frequencies f̂
  errors (..., k) count dtype  per-counter overestimation bound ε

Every function returns the same bits as its JAX counterpart on the same
input, including the order of counters with tied counts: the top-k prune is
a stable descending sort, which keeps the lower pool index first on ties as
``lax.top_k`` does (``torch.topk`` gives no order on ties).

Two update paths, as in the JAX package:

  * :func:`update_scalar` / :func:`spacesaving_scan` — the literal sequential
    algorithm (the oracle), a Python loop over the stream;
  * :func:`update_chunk` / :func:`spacesaving_chunked` — sort a chunk, reduce
    it to an exact histogram, and absorb the histogram into the summary in
    one vectorised step (match + COMBINE offsets + top-k).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

EMPTY = -1  # sentinel item id; real item ids must be >= 0
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


class Summary(NamedTuple):
    """A batch of Space Saving summaries with ``k`` counters each."""

    items: torch.Tensor   # (..., k) int32
    counts: torch.Tensor  # (..., k) count dtype
    errors: torch.Tensor  # (..., k) count dtype

    @property
    def k(self) -> int:
        return self.items.shape[-1]


def init_summary(k: int, count_dtype=torch.int32, *, device,
                 batch: tuple[int, ...] = ()) -> Summary:
    """Empty summaries with ``k`` free counters (the COMBINE identity)."""
    shape = tuple(batch) + (k,)
    return Summary(
        items=torch.full(shape, EMPTY, dtype=torch.int32, device=device),
        counts=torch.zeros(shape, dtype=count_dtype, device=device),
        errors=torch.zeros(shape, dtype=count_dtype, device=device),
    )


def min_frequency(s: Summary) -> torch.Tensor:
    """m = min counter value of a *full* summary, else 0; shape ``(...)``.

    m upper-bounds the count of any item NOT monitored by ``s``. While the
    summary has free counters no item was ever evicted, so the bound is 0.
    """
    full = (s.items != EMPTY).all(-1)
    return torch.where(full, s.counts.amin(-1), torch.zeros_like(full, dtype=s.counts.dtype))


# ---------------------------------------------------------------------------
# Sequential oracle (one stream element per step)
# ---------------------------------------------------------------------------

def update_scalar(s: Summary, x: torch.Tensor) -> Summary:
    """One classical Space Saving step for item ``x`` (shape ``(...)``).

    if x monitored:  f̂(x) += 1
    else:            evict the min counter j:  item←x, f̂←m+1, ε←m
    (a free slot is a counter with count 0, so argmin handles both cases)
    """
    eq = s.items == x[..., None]
    found = eq.any(-1)
    j_min = s.counts.argmin(-1)
    j = torch.where(found, eq.to(torch.int32).argmax(-1), j_min)[..., None]
    m = s.counts.gather(-1, j_min[..., None])
    new_count = torch.where(found[..., None], s.counts.gather(-1, j) + 1, m + 1)
    new_error = torch.where(found[..., None], s.errors.gather(-1, j), m)
    return Summary(
        items=s.items.scatter(-1, j, x[..., None].to(s.items.dtype)),
        counts=s.counts.scatter(-1, j, new_count),
        errors=s.errors.scatter(-1, j, new_error),
    )


def spacesaving_scan(s: Summary, stream: torch.Tensor) -> Summary:
    """Sequential Space Saving over ``stream`` (..., n) (oracle; O(n·k)).

    Elements equal to ``EMPTY`` are skipped (padding).
    """
    for t in range(stream.shape[-1]):
        x = stream[..., t]
        upd = update_scalar(s, x)
        keep = (x == EMPTY)[..., None]
        s = Summary(*(torch.where(keep, a, b) for a, b in zip(s, upd)))
    return s


# ---------------------------------------------------------------------------
# Chunked vectorised update
# ---------------------------------------------------------------------------

def chunk_histogram(chunk: torch.Tensor, count_dtype=torch.int32):
    """Exact histogram of each chunk (..., C) via sort + segment reduction.

    Returns ``(items, weights)`` of the chunk's shape. The first
    ``n_distinct`` positions hold the distinct items in ascending id order
    with their exact counts; the rest are (EMPTY, 0). ``EMPTY`` elements of
    the chunk (stream padding) sort first and are dropped in place, so that
    the layout, which feeds the top-k tie order, is the JAX package's.
    """
    srt = torch.sort(chunk, dim=-1).values
    start = torch.ones_like(srt, dtype=torch.bool)
    start[..., 1:] = srt[..., 1:] != srt[..., :-1]
    seg = torch.cumsum(start, dim=-1) - 1                       # segment ids
    weights = torch.zeros(srt.shape, dtype=count_dtype, device=srt.device)
    weights.scatter_add_(-1, seg, torch.ones_like(weights))
    items = torch.full(srt.shape, INT32_MIN, dtype=torch.int32, device=srt.device)
    items.scatter_reduce_(-1, seg, srt, "amax")
    valid = (items != EMPTY) & (weights > 0)
    return torch.where(valid, items, EMPTY), torch.where(valid, weights, 0)


def merge_pool(s: Summary, cand_items, cand_counts, cand_errors) -> Summary:
    """top-k prune of (summary ∪ candidates) — the eviction step, vectorised.

    Keeps the k largest counters of the pool; on tied counts the lower pool
    index wins (a stable descending sort, the tie order of ``lax.top_k``).
    Invalid candidates must carry count < 0 so they can never displace a
    real (or even an empty, count-0) counter.
    """
    k = s.k
    pool_counts = torch.cat([s.counts, cand_counts], dim=-1)
    pool_items = torch.cat([s.items, cand_items], dim=-1)
    pool_errors = torch.cat([s.errors, cand_errors], dim=-1)
    top_counts, idx = torch.sort(pool_counts, dim=-1, descending=True, stable=True)
    top_counts, idx = top_counts[..., :k], idx[..., :k]
    top_items = pool_items.gather(-1, idx)
    top_errors = pool_errors.gather(-1, idx)
    # a slot that "won" with a negative count is an invalid candidate — only
    # possible when k > |valid pool|; normalise it back to an empty slot.
    neg = top_counts < 0
    return Summary(
        items=torch.where(neg, EMPTY, top_items),
        counts=torch.where(neg, 0, top_counts),
        errors=torch.where(neg, 0, top_errors),
    )


def absorb_pool(s: Summary, cand_items: torch.Tensor, cand_counts: torch.Tensor,
                cand_errors: torch.Tensor | None = None, *, m2=0,
                match_fn=None) -> Summary:
    """The shared merge primitive: match → COMBINE offsets → top-k prune.

    Absorbs a candidate set (an exact histogram, or another summary's
    counters) into ``s`` with the Cafaro et al. COMBINE offsets:

      item in both:        f̂ ← f̂₁ + f̂₂       ε ← ε₁ + ε₂
      s-only item:         f̂ ← f̂₁ + m₂       ε ← ε₁ + m₂
      candidate-only item: f̂ ← f̂₂ + m₁       ε ← ε₂ + m₁

    ``m2`` is the candidates' min frequency, a scalar or one per batch entry
    (0 for an exact histogram, which then passes ``cand_errors=None`` and
    skips the errors channel); m₁ is ``min_frequency(s)``, taken before the
    update. ``match_fn`` has the ``kernels.ops.combine_match`` contract and
    governs every merge: chunk update, histogram merge and COMBINE.
    """
    if match_fn is None:
        from repro_torch.kernels import ops as _kops
        match_fn = _kops.combine_match
    dtype, device = s.counts.dtype, s.counts.device
    m1 = min_frequency(s)[..., None]
    add_c, add_e, matched_s, matched_c = match_fn(
        s.items, cand_items, cand_counts, cand_errors)

    valid1 = s.items != EMPTY
    m2 = torch.as_tensor(m2, dtype=dtype, device=device)
    if m2.ndim:
        m2 = m2[..., None]
    zero = torch.zeros((), dtype=dtype, device=device)
    inc_c = torch.where(matched_s, add_c.to(dtype), m2)
    inc_e = torch.where(matched_s, zero if add_e is None else add_e.to(dtype), m2)
    upd = Summary(
        items=s.items,
        counts=torch.where(valid1, s.counts + inc_c, 0),
        errors=torch.where(valid1, s.errors + inc_e, 0),
    )

    # only unmatched valid candidates enter the pool (+m₁ offsets); invalid
    # ones carry count -1 so the prune never picks them over a real counter.
    cand_valid = (cand_items != EMPTY) & ~matched_c
    ce = zero if cand_errors is None else cand_errors.to(dtype)
    return merge_pool(
        upd,
        torch.where(cand_valid, cand_items, EMPTY),
        torch.where(cand_valid, cand_counts.to(dtype) + m1, -1),
        torch.where(cand_valid, ce + m1, 0),
    )


def merge_histogram(s: Summary, h_items: torch.Tensor, h_weights: torch.Tensor,
                    *, match_fn=None) -> Summary:
    """Merge an EXACT histogram into a summary (COMBINE with m₂ = 0)."""
    return absorb_pool(s, h_items, h_weights, None, m2=0, match_fn=match_fn)


def update_chunk(s: Summary, chunk: torch.Tensor, *, match_fn=None) -> Summary:
    """Process one chunk (..., C) of the stream: histogram + vectorised merge."""
    h_items, h_weights = chunk_histogram(chunk, count_dtype=s.counts.dtype)
    return merge_histogram(s, h_items, h_weights, match_fn=match_fn)


def spacesaving_chunked(s: Summary, stream: torch.Tensor, *,
                        chunk_size: int = 4096, match_fn=None) -> Summary:
    """Chunked Space Saving: ``update_chunk`` over consecutive chunks.

    The stream length must be a multiple of ``chunk_size``; pad with EMPTY
    (see :func:`pad_stream`). This is the per-worker block pass of the
    paper's Algorithm 1.
    """
    n = stream.shape[-1]
    if n % chunk_size:
        raise ValueError(f"stream length {n} is not a multiple of {chunk_size}")
    for j in range(0, n, chunk_size):
        s = update_chunk(s, stream[..., j:j + chunk_size], match_fn=match_fn)
    return s


def pad_stream(stream: torch.Tensor, multiple: int) -> torch.Tensor:
    """Right-pad the last axis with EMPTY so its length divides ``multiple``."""
    rem = (-stream.shape[-1]) % multiple
    if rem == 0:
        return stream
    pad = torch.full(stream.shape[:-1] + (rem,), EMPTY, dtype=stream.dtype,
                     device=stream.device)
    return torch.cat([stream, pad], dim=-1)


# ---------------------------------------------------------------------------
# Queries / reporting
# ---------------------------------------------------------------------------

def bounded_estimates(s: Summary, f: torch.Tensor, eps: torch.Tensor,
                      monitored: torch.Tensor):
    """Raw query outputs → the (f̂, lower, monitored) triple.

    Unmonitored items report the min counter m, an upper bound on any
    unmonitored item's true frequency, with lower bound 0; monitored items
    report (f̂, f̂ − ε). Thus lower ≤ f ≤ f̂ always holds.
    """
    m = min_frequency(s)[..., None]
    f_hat = torch.where(monitored, f, m)
    lower = torch.where(monitored, f - eps, torch.zeros((), dtype=f.dtype, device=f.device))
    return f_hat, lower, monitored


def estimate(s: Summary, queries: torch.Tensor):
    """(f̂, guaranteed lower bound, monitored?) for a batch of item ids."""
    eq = (s.items[..., :, None] == queries[..., None, :]) & (s.items != EMPTY)[..., :, None]
    monitored = eq.any(-2)
    f = (eq * s.counts[..., :, None]).sum(-2).to(s.counts.dtype)
    eps = (eq * s.errors[..., :, None]).sum(-2).to(s.errors.dtype)
    return bounded_estimates(s, f, eps, monitored)


def prune(s: Summary, n, k_majority):
    """Paper's PRUNED step: candidates with f̂ ≥ ⌊n/k⌋+1.

    Returns (items, f̂, candidate_mask, guaranteed_mask); ``guaranteed`` uses
    the per-counter lower bound f̂ − ε, i.e. items certain to be k-majority.
    An all-EMPTY summary or n = 0 yield empty masks.
    """
    if not isinstance(k_majority, torch.Tensor) and int(k_majority) < 1:
        raise ValueError(f"k_majority must be >= 1, got {k_majority}")
    thresh = n // k_majority + 1
    cand = (s.items != EMPTY) & (s.counts >= thresh)
    guaranteed = cand & (s.counts - s.errors >= thresh)
    return s.items, s.counts, cand, guaranteed


def sort_summary(s: Summary, ascending: bool = True) -> Summary:
    """Order counters by frequency (stable; EMPTY slots last either way)."""
    key = torch.where(s.items == EMPTY, INT32_MAX if ascending else -1, s.counts)
    idx = torch.argsort(key if ascending else -key, dim=-1, stable=True)
    return Summary(*(a.gather(-1, idx) for a in s))
