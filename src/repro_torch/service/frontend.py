"""QueryFrontend — plans and batches read-side queries on QuerySnapshots.

The counterpart of ``repro.service.frontend``. Query surface:

  estimate(snap, q)            batched point estimates (f̂, lower, monitored)
                               through ``kernels.ops.query``
  estimate_many(snap, [q...])  several query sets as ONE kernel call
  top(snap, n)                 n heaviest counters (n clamped to [0, k])
  top_table(snap, n)           host-side report rows, EMPTY slots dropped
  threshold(snap, c)           all items with f̂ ≥ c (host side)
  k_majority_report(snap, k')  the paper's query: candidates f̂ ≥ ⌊n/k'⌋+1
                               split into *guaranteed* (f̂ − ε ≥ ⌊n/k'⌋+1)
                               and *unconfirmed* rest

Point-estimate batches are EMPTY-padded up to power-of-two buckets of at
least ``min_batch`` queries, so the query kernel sees few distinct shapes.
``min_batch=None`` takes the ``query_min_batch`` of the plan of the
snapshot's device (16 in the static plan), and ``kernel="auto"`` resolves
through that plan's ``"query"`` table at each call: a frontend serves
snapshots on the CPU and on the card alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.spacesaving import (EMPTY, Summary, bounded_estimates,
                                          prune, sort_summary)
from repro_torch.kernels import ops as kops
from repro_torch.plan import active_plan
from repro_torch.plan import service as plan_service


@dataclasses.dataclass(frozen=True)
class FrequentItemsReport:
    """The k-majority answer, split by guarantee strength (paper §2).

    ``guaranteed`` items satisfy f̂ − ε ≥ ⌊n/k⌋+1, so they are certainly
    k-majority. ``unconfirmed`` items pass the f̂ threshold only; they hold
    every remaining true k-majority item plus possible false positives.
    ``complete`` records whether containment applies (k ≥ k_majority).
    """

    version: int
    n: int
    k_majority: int
    threshold: int               # ⌊n/k⌋ + 1
    complete: bool               # snapshot.k >= k_majority
    guaranteed_items: np.ndarray
    guaranteed_counts: np.ndarray
    guaranteed_lower: np.ndarray     # f̂ − ε per guaranteed item
    unconfirmed_items: np.ndarray
    unconfirmed_counts: np.ndarray
    unconfirmed_lower: np.ndarray

    @property
    def candidate_items(self) -> np.ndarray:
        """Full candidate set (guaranteed first, then unconfirmed)."""
        return np.concatenate([self.guaranteed_items, self.unconfirmed_items])

    @property
    def candidate_counts(self) -> np.ndarray:
        return np.concatenate([self.guaranteed_counts, self.unconfirmed_counts])

    def describe(self) -> dict:
        return {
            "version": self.version,
            "n": self.n,
            "k_majority": self.k_majority,
            "threshold": self.threshold,
            "complete": self.complete,
            "n_guaranteed": int(self.guaranteed_items.size),
            "n_unconfirmed": int(self.unconfirmed_items.size),
        }


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class QueryFrontend:
    """Stateless query planner over QuerySnapshots, one kernel impl.

    ``kernel="fused"`` is accepted, as for an engine: its queries go through
    ``'sorted'``, the matcher of the fused kernels (``kernels.ops.query``).
    """

    def __init__(self, kernel: str = "auto", *, min_batch: int | None = None):
        if kernel not in kops.IMPLS:
            raise ValueError(f"kernel {kernel!r} not in {kops.IMPLS}")
        if min_batch is not None and min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {min_batch}")
        self.kernel = kernel
        self.min_batch = min_batch
        self._floor = (None, 0)     # ((plan generation, device), the plan's floor)

    # -- batch planning ------------------------------------------------------

    def bucket_floor(self, device) -> int:
        """The least padded batch on ``device``: ``min_batch``, or the plan's.

        The plan's answer is kept until the PlanService generation changes,
        as ``kernels.ops.resolve_impl`` keeps its own: a lookup costs tens of
        microseconds, a query a few hundred.
        """
        if self.min_batch is not None:
            return self.min_batch
        key = (plan_service.generation(), str(device))
        if self._floor[0] != key:
            self._floor = (key, active_plan(device).query_min_batch)
        return self._floor[1]

    def _bucket(self, q: int, device) -> int:
        """Smallest power-of-two bucket (>= the floor) holding q queries."""
        return max(self.bucket_floor(device), 1 << max(0, q - 1).bit_length())

    def plan(self, *query_sets, device) -> tuple[torch.Tensor, list[int]]:
        """Concatenate query sets into one EMPTY-padded int32 batch on ``device``.

        ``device`` has no default: the batch goes where the snapshot lives,
        as :meth:`estimate` passes it. Returns (padded (Q,) batch, per-set lengths). EMPTY padding is
        query-neutral: it is reported unmonitored and the unpadding drops it.
        """
        sets = [torch.atleast_1d(torch.as_tensor(q)).to(device=device, dtype=torch.int32)
                for q in query_sets]
        sizes = [int(s.shape[0]) for s in sets]
        flat = torch.cat(sets) if sets else torch.zeros((0,), dtype=torch.int32,
                                                        device=device)
        pad = self._bucket(flat.shape[0], device) - flat.shape[0]
        flat = torch.cat([flat, torch.full((pad,), EMPTY, dtype=torch.int32,
                                           device=device)])
        return flat, sizes

    # -- point estimates -----------------------------------------------------

    def _estimate(self, s: Summary, queries: torch.Tensor):
        f, eps, mon = kops.query(s.items, s.counts, s.errors, queries,
                                 impl=self.kernel)
        return bounded_estimates(s, f, eps, mon)

    def estimate(self, snap, queries):
        """(f̂, guaranteed lower bound, monitored?) per query id.

        f̂ upper-bounds the true frequency for monitored items and equals
        the min counter m for unmonitored ones; ``lower`` = f̂ − ε for
        monitored, 0 otherwise — so lower ≤ f ≤ f̂ always holds.
        """
        s = snap.summary
        padded, sizes = self.plan(queries, device=s.items.device)
        f_hat, lower, mon = self._estimate(s, padded)
        q = sizes[0]
        return f_hat[:q], lower[:q], mon[:q]

    def estimate_many(self, snap, query_sets):
        """Plan several query sets through ONE kernel call; split results."""
        s = snap.summary
        padded, sizes = self.plan(*query_sets, device=s.items.device)
        f_hat, lower, mon = self._estimate(s, padded)
        out, off = [], 0
        for q in sizes:
            out.append((f_hat[off:off + q], lower[off:off + q], mon[off:off + q]))
            off += q
        return out

    # -- ranked / threshold reports -----------------------------------------

    def top(self, snap, n: int = 10):
        """The n heaviest counters, count-descending; n clamped to [0, k].

        Slots beyond the snapshot's occupancy come back as (EMPTY, 0).
        """
        n_eff = max(0, min(int(n), snap.k))
        s = sort_summary(snap.summary, ascending=False)
        return s.items[:n_eff], s.counts[:n_eff]

    def top_table(self, snap, n: int = 10) -> list[dict]:
        """Host-side top-n rows ({item, count, lower}), EMPTY slots dropped."""
        n_eff = max(0, min(int(n), snap.k))
        s = sort_summary(snap.summary, ascending=False)
        items, counts, errors = (_np(a[:n_eff]) for a in s)
        keep = items != EMPTY
        return [{"item": int(i), "count": int(c), "lower": int(c - e)}
                for i, c, e in zip(items[keep], counts[keep], errors[keep])]

    def threshold(self, snap, min_count: int):
        """All monitored items with f̂ ≥ min_count, count-descending."""
        items, counts = _np(snap.summary.items), _np(snap.summary.counts)
        keep = (items != EMPTY) & (counts >= int(min_count))
        order = np.argsort(-counts[keep], kind="stable")
        return items[keep][order], counts[keep][order]

    # -- the paper's query ---------------------------------------------------

    def k_majority_report(self, snap, k_majority: int) -> FrequentItemsReport:
        """Guarantee-split frequent-items report (paper's PRUNED output)."""
        if k_majority < 1:
            raise ValueError(f"k_majority must be >= 1, got {k_majority}")
        items, counts, cand, guaranteed = (
            _np(a) for a in prune(snap.summary, snap.n, k_majority))
        lower = counts - _np(snap.summary.errors)
        unconfirmed = cand & ~guaranteed
        n = int(snap.n)

        def _ranked(mask):
            order = np.argsort(-counts[mask], kind="stable")
            return items[mask][order], counts[mask][order], lower[mask][order]

        gi, gc, gl = _ranked(guaranteed)
        ui, uc, ul = _ranked(unconfirmed)
        return FrequentItemsReport(
            version=snap.version, n=n, k_majority=int(k_majority),
            threshold=n // int(k_majority) + 1,
            complete=snap.k >= int(k_majority),
            guaranteed_items=gi, guaranteed_counts=gc, guaranteed_lower=gl,
            unconfirmed_items=ui, unconfirmed_counts=uc, unconfirmed_lower=ul,
        )
