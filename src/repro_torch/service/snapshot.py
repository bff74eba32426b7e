"""QuerySnapshot — the immutable, versioned read view of a sketch.

The counterpart of ``repro.service.snapshot``. The write path
(SketchEngine) and the read path (QueryFrontend) meet at one object: a
merged summary published by ``SketchEngine.snapshot()`` from the pure flush
view, so queries never flush the publisher's buffer. A snapshot carries
its provenance:

  version   monotonically increasing per publishing engine
  tenants   how many tenant shards were merged into the global summary
  shard_n   (B,) per-tenant item counts at publish time
  kernel    the resolved impl of the engine that built the merge
            (``"fused"`` for a fused engine, whose queries run ``"sorted"``)

Nothing writes a snapshot's tensors after it is published.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.core.spacesaving import EMPTY, Summary, min_frequency


@dataclasses.dataclass(frozen=True)
class QuerySnapshot:
    """One consistent frozen view: (merged summary, total n, provenance)."""

    summary: Summary        # (k,) merged global summary (pending included)
    n: torch.Tensor         # () total valid items ingested at publish time
    version: int            # per-engine monotonic publish counter
    tenants: int            # tenant shards merged into this view
    shard_n: torch.Tensor   # (B,) per-tenant item counts (provenance)
    kernel: str             # resolved kernel impl that produced the merge

    @property
    def k(self) -> int:
        return self.summary.items.shape[-1]

    @property
    def min_count(self) -> torch.Tensor:
        """m — upper bound on any unmonitored item's true frequency."""
        return min_frequency(self.summary)

    @property
    def count_floor(self) -> int:
        """⌊n/k⌋ — the a-priori bound on min_count (the k counters sum to ≤ n)."""
        return int(self.n) // self.k

    @property
    def materialized(self) -> bool:
        return True

    def materialize(self) -> "QuerySnapshot":
        return self

    @property
    def occupancy(self) -> torch.Tensor:
        """Number of live (non-EMPTY) counters in the merged summary."""
        return (self.summary.items != EMPTY).sum()

    def total(self) -> int:
        return int(self.n)

    def describe(self) -> dict:
        """Host-side provenance record."""
        return {
            "version": self.version,
            "k": self.k,
            "n": int(self.n),
            "tenants": self.tenants,
            "shard_n": [int(x) for x in self.shard_n.reshape(-1).tolist()],
            "occupancy": int(self.occupancy),
            "min_count": int(self.min_count),
            "kernel": self.kernel,
        }


class LazyQuerySnapshot:
    """A QuerySnapshot whose merged summary materializes on first read.

    Publishing captures a state (``SketchEngine.snapshot`` gives it its own
    copy of a partly filled buffer) plus cheap host scalars; the reduction
    runs once, on the first read of ``summary``/``n``/…, and the thunk is
    then dropped. Thread-safe: concurrent readers race to a double-checked
    lock and all get the same frozen :class:`QuerySnapshot`.
    """

    def __init__(self, thunk: Callable[[], QuerySnapshot], *, version: int,
                 kernel: str, k: int, n_hint: int | None = None,
                 on_materialize: Callable[[], None] | None = None):
        self._thunk = thunk
        self._lock = threading.Lock()
        self._snap: QuerySnapshot | None = None
        self._on_materialize = on_materialize
        self.version = int(version)
        self.kernel = str(kernel)
        self.k = int(k)
        #: publish-time item count from the writer's own accounting; None → unknown
        self.n_hint = None if n_hint is None else int(n_hint)

    @property
    def materialized(self) -> bool:
        return self._snap is not None

    @property
    def count_floor(self) -> int:
        """⌊n/k⌋ without materializing (materializes when no hint was given)."""
        if self._snap is not None:
            return self._snap.count_floor
        if self.n_hint is not None:
            return self.n_hint // self.k
        return self.materialize().count_floor

    def materialize(self) -> QuerySnapshot:
        """Run the deferred reduction once; cached for every later read."""
        snap = self._snap
        if snap is None:
            with self._lock:
                if self._snap is None:
                    self._snap = self._thunk()
                    self._thunk = None      # release the state reference
                    if self._on_materialize is not None:
                        self._on_materialize()
                        self._on_materialize = None
                snap = self._snap
        return snap

    @property
    def summary(self) -> Summary:
        return self.materialize().summary

    @property
    def n(self) -> torch.Tensor:
        return self.materialize().n

    @property
    def tenants(self) -> int:
        return self.materialize().tenants

    @property
    def shard_n(self) -> torch.Tensor:
        return self.materialize().shard_n

    @property
    def min_count(self) -> torch.Tensor:
        return self.materialize().min_count

    @property
    def occupancy(self) -> torch.Tensor:
        return self.materialize().occupancy

    def total(self) -> int:
        return self.materialize().total()

    def describe(self) -> dict:
        return self.materialize().describe()


def publish(summary: Summary, n, shard_n, *, version: int, kernel: str) -> QuerySnapshot:
    """Freeze a merged summary into a QuerySnapshot."""
    shard_n = torch.atleast_1d(torch.as_tensor(shard_n))
    return QuerySnapshot(summary=summary, n=torch.as_tensor(n),
                         version=int(version), tenants=int(shard_n.shape[0]),
                         shard_n=shard_n, kernel=str(kernel))


def publish_lazy(thunk: Callable[[], QuerySnapshot], *, version: int, kernel: str,
                 k: int, n_hint: int | None = None,
                 on_materialize=None) -> LazyQuerySnapshot:
    """Freeze a *deferred* snapshot: cheap scalars now, reduction on read.

    ``thunk`` must produce the eager :class:`QuerySnapshot` of exactly this
    ``version`` (same state, same reduction).
    """
    return LazyQuerySnapshot(thunk, version=version, kernel=kernel, k=k,
                             n_hint=n_hint, on_materialize=on_materialize)
