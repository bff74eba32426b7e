"""Synthetic zipf streams (the paper's input distribution), numpy only.

A copy of ``fold_ids`` and ``zipf_stream`` from ``repro.data.synthetic``:
the same seed gives the same ids, so that both packages are fed one stream.
The paper evaluates on zipf(1.1)/zipf(1.8) streams (Table I).
"""
from __future__ import annotations

import numpy as np


def fold_ids(ids: np.ndarray, max_id: int, mode: str = "mod") -> np.ndarray:
    """Map 1-based item ids above ``max_id`` back into [1, max_id].

    ``'mod'``  — ``(x-1) % max_id + 1``: spreads the tail mass across the
    whole id range, so head frequencies stay faithful to the zipf law.
    ``'clip'`` — ``min(x, max_id)``: piles all tail mass onto ``max_id``,
    kept only to reproduce the older streams bit for bit.
    """
    if mode == "mod":
        return (ids - 1) % max_id + 1
    if mode == "clip":
        return np.minimum(ids, max_id)
    raise ValueError(f"fold mode {mode!r} not in ('mod', 'clip')")


def zipf_stream(n: int, skew: float, seed: int = 0,
                max_id: int | None = None, fold: str = "mod") -> np.ndarray:
    """n zipf(skew) item ids (int32, ≥ 1), folded into [1, max_id]."""
    rng = np.random.default_rng(seed)
    out = rng.zipf(skew, size=n)
    # rng.zipf returns int64 and at low skew exceeds int32 with real
    # probability, so an uncapped stream still folds before the int32 cast.
    cap = max_id if max_id is not None else np.iinfo(np.int32).max
    return fold_ids(out, cap, fold).astype(np.int32)
