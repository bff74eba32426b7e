"""The comparison that decides ``correct``.

After the window has closed, a sample of its epochs drawn from the seed is
worked out again by the plain reference (``reference.py``) from the same
pool slices, and the system's answers for those epochs are compared with it
and with the epoch's exact counts. Every epoch of the window is checked for
its item count. The numbers compared, each with the limit 0:

  epochs_wrong_n        epochs whose report counts other than the mix's
                        epoch_items ids
  summary_mismatch      slots of the sampled epochs' merged summaries whose
                        (id, count, error) differs from the reference's
  report_mismatch       sampled epochs whose k-majority report or top-n list
                        differs from the reference's in any entry
  guarantee_violations  in the sampled epochs, against exact counts: the
                        monitored slots and top-n rows for which
                        f̂ − ε ≤ f ≤ f̂ fails, the guaranteed items with
                        f < ⌊n/k'⌋+1, and the items with f ≥ ⌊n/k'⌋+1 missing
                        from the candidates (the paper's containment)

The system claims bitwise equality with its own plain path, so the first
three are exact comparisons; the last counts breaches of the paper's
guarantees, which allow none.
"""
from __future__ import annotations

import numpy as np
import torch

from sketchbench import reference
from sketchbench.traffic import sample_epochs

#: sampled epochs worked out again by the reference in every run
SAMPLE = 4

#: the numbers compared, each with its limit (a number may not exceed it)
LIMITS = {
    "epochs_wrong_n": 0,
    "summary_mismatch": 0,
    "report_mismatch": 0,
    "guarantee_violations": 0,
}


def epoch_blocks(pool, offset: int, mix: dict):
    """The blocks of one epoch as the system was handed them (pool views)."""
    bs = mix["block_items"]
    return [pool[offset + b * bs: offset + (b + 1) * bs]
            for b in range(mix["epoch_items"] // bs)]


def exact_counts(pool, offset: int, mix: dict) -> np.ndarray:
    ids = pool[offset: offset + mix["epoch_items"]]
    return torch.bincount(ids.to(torch.int64), minlength=mix["max_id"] + 1).cpu().numpy()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _freq(f: np.ndarray, ids) -> np.ndarray:
    """Exact counts of ``ids``; 0 for an id outside the mix's range."""
    ids = np.asarray(ids, dtype=np.int64)
    ok = (ids >= 0) & (ids < f.shape[0])
    return np.where(ok, f[np.where(ok, ids, 0)], 0)


def _report_equal(got: dict, want: dict) -> bool:
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            if g.shape != w.shape or not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
                return False
        elif int(g) != int(w):
            return False
    return True


def compare(answers, *, pool, mix: dict, config: dict, seed: int) -> tuple[dict, int]:
    """The numbers compared for a window's answers, and the epochs that failed.

    ``answers`` is a list, one per epoch in order, of dicts with ``offset``,
    ``n``, ``summary`` (numpy items, counts, errors), ``report`` (the keys of
    ``reference.report``) and ``top`` (items, counts).
    """
    dtype = getattr(torch, config["count_dtype"])
    k_maj, top_n = config["k_majority"], config["top_n"]
    numbers = {name: 0 for name in LIMITS}
    wrong = {i for i, a in enumerate(answers) if int(a["n"]) != mix["epoch_items"]}
    numbers["epochs_wrong_n"] = len(wrong)
    for i in sample_epochs(seed, len(answers), SAMPLE):
        before = dict(numbers)
        a = answers[i]
        (r_items, r_counts, r_errors), r_n = reference.merged_epoch(
            epoch_blocks(pool, a["offset"], mix), k=config["k_counters"],
            lanes=config["lanes"], window=config["chunk"] * config["buffer_depth"],
            count_dtype=dtype)
        items, counts, errors = (_host(x) for x in a["summary"])
        numbers["summary_mismatch"] += int(np.sum(
            (items != r_items) | (counts.astype(np.int64) != r_counts.astype(np.int64))
            | (errors.astype(np.int64) != r_errors.astype(np.int64))))
        want = reference.report(r_items, r_counts, r_errors, r_n, k_maj)
        t_items, t_counts = reference.top(r_items, r_counts, top_n)
        same = (_report_equal(a["report"], want)
                and np.array_equal(a["top"][0], t_items)
                and np.array_equal(np.asarray(a["top"][1]).astype(np.int64),
                                   t_counts.astype(np.int64)))
        numbers["report_mismatch"] += not same
        f = exact_counts(pool, a["offset"], mix)
        live = items != reference.EMPTY
        fi = _freq(f, items)
        c64, e64 = counts.astype(np.int64), errors.astype(np.int64)
        bad = int(np.sum(live & ((c64 - e64 > fi) | (fi > c64))))
        ti, tc = (np.asarray(x) for x in a["top"])
        tl = ti != reference.EMPTY
        bad += int(np.sum(tl & (_freq(f, ti) > tc)))
        rep = a["report"]
        thr = mix["epoch_items"] // k_maj + 1          # of the exact n
        g = np.asarray(rep["guaranteed_items"], dtype=np.int64)
        bad += int(np.sum(_freq(f, g) < thr))
        truth = np.flatnonzero(f >= thr)
        cand = np.concatenate([g, np.asarray(rep["unconfirmed_items"], dtype=np.int64)])
        bad += int(np.sum(~np.isin(truth, cand)))
        numbers["guarantee_violations"] += bad
        if numbers != before:
            wrong.add(i)
    return numbers, len(wrong)


def verdict(numbers: dict) -> dict:
    """{name: {"value", "limit", "ok"}} in the order of LIMITS."""
    return {name: {"value": numbers[name], "limit": limit, "ok": numbers[name] <= limit}
            for name, limit in LIMITS.items()}
