"""RuntimeConfig — topology + reduction policy around a wrapped EngineConfig.

The counterpart of ``repro.runtime.config``. The runtime owns everything the
engine deliberately does not: how many shards ingest concurrently (the
paper's MPI-rank level: one ``torch.distributed`` rank each), how those
shards are grouped into pods (the hybrid MPI/OpenMP topology), which
reduction strategy stitches shard summaries into the global one, and how
host blocks are staged onto the device. The wrapped
:class:`~repro_torch.engine.EngineConfig` keeps describing ONE shard's
policy — its ``tenants`` field is the number of lanes per shard (the
OpenMP-thread level), so the total worker count of a runtime is
``shards × lanes``.

Frozen and hashable, like EngineConfig, so runtimes can be cached. Every
``None``/``'auto'`` resolves through the plan of the engine's device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.engine.config import EngineConfig


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static configuration of one :class:`~repro_torch.runtime.StreamRuntime`."""

    engine: EngineConfig = EngineConfig()
    shards: int | None = None   # p — shards; None → the world size (1 without
                                # a default process group)
    pods: int | None = 1        # outer mesh dim (>1 → ("pod","data") mesh);
                                # None → the active plan's split for p shards
    reduction: str | None = None   # cross-shard strategy; None → engine's,
                                   # 'auto' → the active plan's choice for p
    feed_depth: int | None = None  # host→device staging slots; None → the
                                   # active plan's depth (static: 2)

    def __post_init__(self):
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1 or None, got {self.shards}")
        if self.pods is not None and self.pods < 1:
            raise ValueError(f"pods must be >= 1 or None, got {self.pods}")
        if (self.shards is not None and self.pods is not None
                and self.pods > 1 and self.shards % self.pods):
            raise ValueError(
                f"pods ({self.pods}) must divide shards ({self.shards})")
        if self.feed_depth is not None and self.feed_depth < 1:
            raise ValueError(
                f"feed_depth must be >= 1 or None, got {self.feed_depth}")
        if self.reduction is not None and self.reduction != "auto":
            from repro_torch.engine.reductions import reduction_names
            if self.reduction not in reduction_names():
                raise ValueError(
                    f"reduction {self.reduction!r} not registered; have "
                    f"{sorted(reduction_names())} (or 'auto' for the "
                    f"plan-resolved strategy)")

    @property
    def lanes(self) -> int:
        """Sketch lanes per shard (the OpenMP-thread level)."""
        return self.engine.tenants

    def resolved_reduction(self, shards: int | None = None) -> str:
        """Collapse the strategy choice for a ``shards``-wide data dimension.

        ``'auto'`` goes through the PlanService ('local' / 'butterfly'
        without a measured table); ``None`` defers to the wrapped engine's
        declared strategy.
        """
        if self.reduction == "auto":
            from repro_torch.plan import resolve_reduction
            p = shards if shards is not None else (self.shards or 1)
            return resolve_reduction(p, self.engine.device)
        return self.reduction if self.reduction is not None \
            else self.engine.reduction

    def resolved_pods(self, shards: int) -> int:
        """The pod split for ``shards`` ranks (None → plan-resolved)."""
        if self.pods is not None:
            return self.pods
        from repro_torch.plan import active_plan
        return active_plan(self.engine.device).pods_for(shards)

    def resolved_feed_depth(self) -> int:
        """Staging slots in the host→device feed (None → plan-resolved)."""
        if self.feed_depth is not None:
            return self.feed_depth
        from repro_torch.plan import active_plan
        return active_plan(self.engine.device).feed_depth
