"""Exact counting oracle + the paper's evaluation metrics (numpy).

A copy of ``repro.core.exact`` that takes tensors or arrays, so that the
port needs nothing of the JAX package. The paper reports (§4): Average
Relative Error over the reported items' frequencies, precision (reported ∩
true / reported) and recall (reported ∩ true / true).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.spacesaving import EMPTY


class Metrics(NamedTuple):
    are: float        # average relative error over reported items
    precision: float
    recall: float
    n_true: int
    n_reported: int


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def exact_counts(stream) -> dict[int, int]:
    items, counts = np.unique(_np(stream), return_counts=True)
    return {int(i): int(c) for i, c in zip(items, counts) if i != EMPTY}


def true_heavy_hitters(stream, k_majority: int) -> dict[int, int]:
    n = int((_np(stream) != EMPTY).sum())
    thresh = n // k_majority + 1
    return {i: c for i, c in exact_counts(stream).items() if c >= thresh}


def score_reported(reported: dict[int, int], truth: dict[int, int],
                   exact: dict[int, int]) -> Metrics:
    """Paper §4 metrics for any reported {item: f̂} set (the metric core)."""
    hits = [i for i in reported if i in truth]
    precision = len(hits) / len(reported) if reported else 1.0
    recall = len(hits) / len(truth) if truth else 1.0
    rel_errors = [abs(reported[i] - exact.get(i, 0)) / max(exact.get(i, 0), 1)
                  for i in reported]
    are = float(np.mean(rel_errors)) if rel_errors else 0.0
    return Metrics(are=are, precision=precision, recall=recall,
                   n_true=len(truth), n_reported=len(reported))


def evaluate(summary, stream, k_majority: int,
             reported_mask: np.ndarray | None = None) -> Metrics:
    """Score a (k,) summary against the exact oracle (paper §4 metrics)."""
    stream = _np(stream)
    items = _np(summary.items)
    counts = _np(summary.counts)
    n = int((stream != EMPTY).sum())
    thresh = n // k_majority + 1
    if reported_mask is None:
        reported_mask = (items != EMPTY) & (counts >= thresh)
    reported = {int(i): int(c) for i, c in zip(items[reported_mask],
                                               counts[reported_mask])}
    return score_reported(reported, true_heavy_hitters(stream, k_majority),
                          exact_counts(stream))


def overestimation_violations(summary, stream) -> int:
    """# monitored items violating f ≤ f̂ ≤ f + ε (must be 0)."""
    exact = exact_counts(stream)
    bad = 0
    for i, c, e in zip(_np(summary.items), _np(summary.counts),
                       _np(summary.errors)):
        if i == EMPTY:
            continue
        f = exact.get(int(i), 0)
        if not (f <= c <= f + e):
            bad += 1
    return bad
