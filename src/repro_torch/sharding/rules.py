"""The single-process ShardingPlan.

The counterpart of ``repro.sharding.rules.ShardingPlan`` with ``mesh=None``,
which is all the serving step and its launcher use: ``wsc`` (the
activation-sharding hook the model code calls at 'bsd', 'bshd', ...) is the
identity, ``axis_sizes`` is empty and ``batch_axes`` names the data axis,
so the token sketch has one group. The mesh resolver (``PARAM_RULES``,
``param_specs``, the activation specs) waits for ROADMAP.md §1 item 7.
"""
from __future__ import annotations


class ShardingPlan:
    """Resolved sharding for one arch on one process (no mesh)."""

    def __init__(self, cfg, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "ShardingPlan: only mesh=None is ported (ROADMAP.md §1 item 7)")
        self.cfg = cfg
        self.mesh = None
        self.axis_sizes: dict = {}
        self.batch_axes = ("data",)

    def wsc(self, x, code: str):
        return x
