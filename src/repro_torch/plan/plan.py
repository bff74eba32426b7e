"""ExecutionPlan — one immutable, auditable answer to every "auto".

The counterpart of ``repro.plan.plan``. A plan either comes from
*measurement* (``source == "measured"``, built by
``python -m repro_torch.launch.tune`` from probes timed on the device) or is
the documented zero-measurement fallback (``source == "static"``).

A plan stores decisions, not raw probe data: per-op kernel impls at the
probed counter budgets, the reduction strategy and pod split per shard
count, the chunk / buffer geometry, the frontend's query bucketing floor,
and the serving knobs the tier and the runtime resolve their ``None`` to
(``publish_every``, ``ring_depth``, ``coalesce_max``, ``feed_depth``,
``lazy_publish``). Lookups between probed budgets snap to the nearest
probed value in log-space. The JSON format is the JAX
package's format 1, with the port's impl names:

  JAX        port
  'pallas'   'cuda'    the hand-written kernels (``csrc/``)
  'jnp'      'torch'   the dense plain versions
  'sorted'   'sorted'
  'fused'    'fused'

The reduction and pod tables hold the p > 1 cells the tune CLI probed; a
one-card host probes p = 1 only and leaves them empty, and
``reduction_for`` / ``pods_for`` then answer the static default
(``butterfly`` on one pod).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Mapping

from repro_torch.plan.fingerprint import device_type

PLAN_FORMAT = 1

#: ops with a dispatchable kernel choice (``kernels/ops.py``): 'update' is
#: ``match_weights``, 'combine' ``combine_match``, 'query' ``query`` and
#: 'flush' the window-level merge ``ingest_window``, where the fused kernel
#: competes against the separate-dispatch impls
PLAN_OPS = ("update", "combine", "query", "flush")

#: concrete impls a plan may route to. 'fused' is measurement-only:
#: static_impl never returns it
PLAN_IMPLS = ("cuda", "torch", "sorted", "fused")

# below this counter budget the dense plain version beats sort +
# searchsorted off the card: THE static threshold, the JAX package's
# SORTED_MIN_K
SORTED_MIN_K = 256


def _nearest_log(keys, x: int) -> int:
    """The probed grid point nearest to ``x`` in log-space."""
    return min(keys, key=lambda p: (abs(math.log2(max(x, 1) / p)), p))


def static_impl(op: str, k: int, *, on_cuda: bool) -> str:
    """The zero-measurement kernel rule.

    On the card the hand-written kernels (``'cuda'``), as JAX gives
    ``'pallas'`` on a TPU. Off the card the JAX package's off-TPU rule:
    ``update`` takes the dense plain version; the other ops the sorted
    merge-join from ``SORTED_MIN_K`` counters up and the dense version
    below. Never ``'fused'``: only a measurement may route there.
    """
    if op not in PLAN_OPS:
        raise ValueError(f"op {op!r} not in {PLAN_OPS}")
    if on_cuda:
        return "cuda"
    if op == "update":
        return "torch"
    return "sorted" if k >= SORTED_MIN_K else "torch"


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Immutable per-device decision table (see module docstring)."""

    fingerprint: str
    source: str                              # 'measured' | 'static'
    kernels: Mapping[str, Mapping[int, str]]  # op -> {probed k -> impl}
    reductions: Mapping[int, str]            # axis size p -> strategy
    pods: Mapping[int, int]                  # axis size p -> pod split
    chunk: int = 2048                        # recommended C
    buffer_depth: int = 8                    # recommended T
    query_min_batch: int = 16                # QueryFrontend bucket floor
    publish_every: int = 8                   # serving: blocks per ring publish
    ring_depth: int = 4                      # serving: SnapshotRing slots
    coalesce_max: int = 1                    # serving: max blocks per dispatch
    feed_depth: int = 2                      # host→device staging slots
    lazy_publish: bool = False               # serving: defer snapshot reduce
    format: int = PLAN_FORMAT

    def __post_init__(self):
        if self.source not in ("measured", "static"):
            raise ValueError(f"source {self.source!r} not in ('measured', 'static')")
        bad = set(self.kernels) - set(PLAN_OPS)
        if bad:
            raise ValueError(f"unknown plan ops {sorted(bad)}; have {PLAN_OPS}")
        for op, table in self.kernels.items():
            bad_impls = set(table.values()) - set(PLAN_IMPLS)
            if bad_impls:
                raise ValueError(f"plan op {op!r} routes to unknown impl(s) "
                                 f"{sorted(bad_impls)}; have {PLAN_IMPLS}")
        if self.chunk <= 0 or self.buffer_depth <= 0 or self.query_min_batch <= 0:
            raise ValueError(
                f"chunk/buffer_depth/query_min_batch must be positive: "
                f"{self.chunk}/{self.buffer_depth}/{self.query_min_batch}")
        if self.publish_every <= 0 or self.ring_depth <= 0:
            raise ValueError(f"publish_every/ring_depth must be positive: "
                             f"{self.publish_every}/{self.ring_depth}")
        if self.coalesce_max < 1 or self.feed_depth < 1:
            raise ValueError(f"coalesce_max/feed_depth must be >= 1: "
                             f"{self.coalesce_max}/{self.feed_depth}")
        if not isinstance(self.lazy_publish, bool):
            raise ValueError(f"lazy_publish must be a bool, got {self.lazy_publish!r}")

    @property
    def device_type(self) -> str:
        """The device type this plan was made for (its fingerprint's first word)."""
        return device_type(self.fingerprint)

    # -- resolution ----------------------------------------------------------

    def impl_for(self, op: str, k: int) -> str:
        """The kernel impl this plan picks for ``op`` at counter budget k."""
        table = self.kernels.get(op) or {}
        if not table:
            return static_impl(op, k, on_cuda=self.device_type == "cuda")
        return table[_nearest_log(table.keys(), k)]

    def reduction_for(self, p: int) -> str:
        """The cross-shard strategy for a p-wide reduction axis."""
        if p <= 1:
            return "local"
        if not self.reductions:
            return "butterfly"
        return self.reductions[_nearest_log(self.reductions.keys(), p)]

    def pods_for(self, p: int) -> int:
        """The pod split for p shards (1 → flat single-pod mesh)."""
        if p <= 1 or not self.pods:
            return 1
        pods = self.pods[_nearest_log(self.pods.keys(), p)]
        return pods if pods >= 1 and p % pods == 0 else 1

    # -- serialization -------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "format": self.format,
            "fingerprint": self.fingerprint,
            "source": self.source,
            "kernels": {op: {str(k): impl for k, impl in sorted(tbl.items())}
                        for op, tbl in self.kernels.items()},
            "reductions": {str(p): s for p, s in sorted(self.reductions.items())},
            "pods": {str(p): n for p, n in sorted(self.pods.items())},
            "chunk": self.chunk,
            "buffer_depth": self.buffer_depth,
            "query_min_batch": self.query_min_batch,
            "publish_every": self.publish_every,
            "ring_depth": self.ring_depth,
            "coalesce_max": self.coalesce_max,
            "feed_depth": self.feed_depth,
            "lazy_publish": self.lazy_publish,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ExecutionPlan":
        if d.get("format") != PLAN_FORMAT:
            raise ValueError(f"plan format {d.get('format')!r} != {PLAN_FORMAT}; "
                             f"re-run `python -m repro_torch.launch.tune`")
        return cls(
            fingerprint=d["fingerprint"],
            source=d["source"],
            kernels={op: {int(k): impl for k, impl in tbl.items()}
                     for op, tbl in d.get("kernels", {}).items()},
            reductions={int(p): s for p, s in d.get("reductions", {}).items()},
            pods={int(p): int(n) for p, n in d.get("pods", {}).items()},
            chunk=int(d.get("chunk", 2048)),
            buffer_depth=int(d.get("buffer_depth", 8)),
            query_min_batch=int(d.get("query_min_batch", 16)),
            publish_every=int(d.get("publish_every", 8)),
            ring_depth=int(d.get("ring_depth", 4)),
            coalesce_max=int(d.get("coalesce_max", 1)),
            feed_depth=int(d.get("feed_depth", 2)),
            lazy_publish=bool(d.get("lazy_publish", False)),
        )

    def save(self, path: os.PathLike | str) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        # unique temp + atomic rename: two concurrent tuners for the same
        # fingerprint each publish a complete file, never a torn one
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(self.to_json(), indent=2) + "\n")
            Path(tmp).replace(path)
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
        return path

    @classmethod
    def load(cls, path: os.PathLike | str) -> "ExecutionPlan":
        return cls.from_json(json.loads(Path(path).read_text()))


def static_plan(fingerprint: str) -> ExecutionPlan:
    """The zero-measurement fallback plan: empty tables, so every lookup
    answers :func:`static_impl` for the fingerprint's device type."""
    return ExecutionPlan(fingerprint=fingerprint, source="static",
                         kernels={}, reductions={}, pods={})
