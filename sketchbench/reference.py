"""The plain reference: Space Saving, the paper's parallel version, its report.

Plain PyTorch (batched over lanes, on whatever device the tensors are) and
numpy, written from the paper and from the semantics the port documents,
and importing nothing of the port. It takes the same blocks of ids that
the system under test was handed and works out again:

  * the decomposition: each block split into ``lanes`` contiguous rows
    (the paper's block decomposition), each row cut into windows of
    ``chunk × depth`` ids in arrival order;
  * each flush: the window's exact histogram absorbed into the lane's
    summary with the COMBINE offsets (m₂ = 0), the k largest kept;
  * the merge: the adjacent-pair COMBINE tree over the lanes
    (Cafaro, Pulimeno, Tempesta 2016; the paper's ParallelReduction);
  * the report: the k-majority candidates f̂ ≥ ⌊n/k'⌋+1 split into
    guaranteed (f̂ − ε ≥ ⌊n/k'⌋+1) and unconfirmed, each by count,
    descending; and the top n counters.

Ties: where two pool entries have equal counts, the one earlier in the
pool wins, and the pool is [the summary's k slots in slot order, then the
candidates]: a window's distinct ids in ascending order, or the second
summary's slots in slot order. Sums are taken in the count type and wrap.

``count_dtype`` may be narrower than the system's: that is the control.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EMPTY = -1
_ID_MAX = 2**31 - 1


class Sketch(NamedTuple):
    items: torch.Tensor    # (B, k) int32, EMPTY for a free slot
    counts: torch.Tensor   # (B, k) count dtype
    errors: torch.Tensor   # (B, k) count dtype


def empty(lanes: int, k: int, count_dtype, device) -> Sketch:
    return Sketch(torch.full((lanes, k), EMPTY, dtype=torch.int32, device=device),
                  torch.zeros((lanes, k), dtype=count_dtype, device=device),
                  torch.zeros((lanes, k), dtype=count_dtype, device=device))


def floor_count(s: Sketch) -> torch.Tensor:
    """m per lane: the least count of a full summary, else 0 (no eviction yet)."""
    full = (s.items != EMPTY).all(-1)
    least = s.counts.min(-1).values
    return torch.where(full, least, torch.zeros_like(least))


def histogram(window: torch.Tensor, count_dtype):
    """Distinct ids of each row in ascending order with their exact counts.

    Returns (ids (B, W) int32, counts (B, W)); a row's distinct ids come
    first, the rest is (EMPTY, 0). EMPTY ids in the window are not counted.
    """
    b, w = window.shape
    srt = torch.sort(torch.where(window == EMPTY, _ID_MAX, window), dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first &= srt != _ID_MAX
    rank = torch.cumsum(first.to(torch.int64), 1) - 1         # distinct id's rank
    live = srt != _ID_MAX
    ids = torch.full((b, w), EMPTY, dtype=torch.int32, device=window.device)
    counts = torch.zeros((b, w), dtype=count_dtype, device=window.device)
    rank = torch.where(live, rank, w - 1)                     # a dead slot's sink
    counts.scatter_add_(1, rank, live.to(count_dtype))
    ids.scatter_(1, torch.where(first, rank, w - 1), torch.where(first, srt, EMPTY))
    distinct = first.sum(1, keepdim=True)
    col = torch.arange(w, device=window.device)[None]
    keep = col < distinct
    return torch.where(keep, ids, EMPTY), torch.where(keep, counts, 0)


def absorb(s: Sketch, c_items, c_counts, c_errors, m2) -> Sketch:
    """Merge candidates (distinct ids per row) into ``s``; keep the k largest.

    In both: f̂ = f̂₁ + f̂₂, ε = ε₁ + ε₂. Only in ``s``: f̂₁ + m₂, ε₁ + m₂.
    Only among the candidates: f̂₂ + m₁, ε₂ + m₁, with m₁ = floor_count(s).
    """
    b, k = s.items.shape
    dt = s.counts.dtype
    m1 = floor_count(s)[:, None]
    m2 = m2[:, None]
    c_valid = c_items != EMPTY
    key = torch.where(c_valid, c_items, _ID_MAX)
    order = torch.argsort(key, dim=1)
    sorted_ids = torch.gather(key, 1, order)
    pos = torch.searchsorted(sorted_ids, s.items.contiguous()).clamp_(max=key.shape[1] - 1)
    hit = (torch.gather(sorted_ids, 1, pos) == s.items) & (s.items != EMPTY)
    where_c = torch.gather(order, 1, pos)                     # candidate column
    add_c = torch.where(hit, torch.gather(c_counts, 1, where_c), m2)
    add_e = torch.where(hit, torch.gather(c_errors, 1, where_c), m2)
    live = s.items != EMPTY
    counts = torch.where(live, s.counts + add_c, 0)
    errors = torch.where(live, s.errors + add_e, 0)
    taken = torch.zeros(c_valid.shape, dtype=torch.int64, device=c_valid.device)
    taken.scatter_add_(1, torch.where(hit, where_c, 0), hit.to(torch.int64))
    enter = c_valid & (taken == 0)
    pool_items = torch.cat([s.items, torch.where(enter, c_items, EMPTY)], 1)
    never = torch.tensor(-1, dtype=dt, device=counts.device)   # loses to every slot
    pool_counts = torch.cat([counts, torch.where(enter, c_counts + m1, never)], 1)
    pool_errors = torch.cat([errors, torch.where(enter, c_errors + m1, 0)], 1)
    order = torch.sort(pool_counts, dim=1, descending=True, stable=True).indices[:, :k]
    items = torch.gather(pool_items, 1, order)
    counts = torch.gather(pool_counts, 1, order)
    errors = torch.gather(pool_errors, 1, order)
    dead = counts < 0
    return Sketch(torch.where(dead, EMPTY, items), torch.where(dead, 0, counts),
                  torch.where(dead, 0, errors))


def flush(s: Sketch, window: torch.Tensor) -> Sketch:
    """One deferred flush of a (B, W) window into the lanes' summaries."""
    h_ids, h_counts = histogram(window, s.counts.dtype)
    zero = torch.zeros(s.items.shape[0], dtype=s.counts.dtype, device=s.items.device)
    return absorb(s, h_ids, h_counts, torch.zeros_like(h_counts), zero)


def combine(a: Sketch, b: Sketch) -> Sketch:
    """COMBINE of two batches of summaries, pair by pair."""
    return absorb(a, b.items, b.counts, b.errors, floor_count(b))


def merge_lanes(s: Sketch) -> Sketch:
    """The adjacent-pair COMBINE tree: lanes (2i, 2i+1) each round, to one."""
    lanes = s.items.shape[0]
    if lanes & (lanes - 1):
        raise ValueError(f"the reference merges a power of two of lanes, got {lanes}")
    while s.items.shape[0] > 1:
        s = combine(Sketch(*(a[0::2] for a in s)), Sketch(*(a[1::2] for a in s)))
    return s


def ingest_epoch(blocks, *, k: int, lanes: int, window: int, count_dtype) -> tuple:
    """Every flush of an epoch handed over as ``blocks`` (flat id tensors).

    Each block is split into ``lanes`` rows, each row into windows of
    ``window`` ids. Returns (lane summaries, ids counted), the count kept
    per lane in the count type and summed in it, as the summaries' counts.
    """
    first = blocks[0]
    s = empty(lanes, k, count_dtype, first.device)
    n = torch.zeros(lanes, dtype=count_dtype, device=first.device)
    for block in blocks:
        if block.numel() % (lanes * window):
            raise ValueError("the reference takes blocks of whole windows per lane")
        rows = block.reshape(lanes, -1)
        for lo in range(0, rows.shape[1], window):
            s = flush(s, rows[:, lo:lo + window])
        n += (rows != EMPTY).sum(1).to(count_dtype)
    return s, int(n.sum(dtype=count_dtype))


def merged_epoch(blocks, **kw) -> tuple:
    """(the merged summary as numpy (items, counts, errors), n) of an epoch."""
    lanes_summary, n = ingest_epoch(blocks, **kw)
    m = merge_lanes(lanes_summary)
    return tuple(a[0].cpu().numpy() for a in m), n


# -- the read side (host, numpy) ---------------------------------------------

def report(items, counts, errors, n: int, k_majority: int) -> dict:
    """The k-majority report of a merged summary (numpy arrays)."""
    threshold = n // k_majority + 1
    cand = (items != EMPTY) & (counts >= threshold)
    sure = cand & (counts - errors >= threshold)
    lower = counts - errors

    def ranked(mask):
        order = np.argsort(-counts[mask].astype(np.int64), kind="stable")
        return (items[mask][order], counts[mask][order], lower[mask][order])

    g, u = ranked(sure), ranked(cand & ~sure)
    return {"n": n, "threshold": threshold,
            "guaranteed_items": g[0], "guaranteed_counts": g[1], "guaranteed_lower": g[2],
            "unconfirmed_items": u[0], "unconfirmed_counts": u[1], "unconfirmed_lower": u[2]}


def top(items, counts, n: int):
    """The n heaviest counters, by count descending, slot order on ties;
    free slots last."""
    key = np.where(items == EMPTY, -1, counts.astype(np.int64))
    order = np.argsort(-key, kind="stable")[:min(n, items.shape[0])]
    return items[order], counts[order]
