"""PlanService — measured choices behind every "auto" of the port.

The counterpart of ``repro.plan``:

  * :mod:`repro_torch.plan.fingerprint` — device fingerprint + plan-cache paths;
  * :mod:`repro_torch.plan.probe`       — timed probes of the dispatch surface;
  * :mod:`repro_torch.plan.model`       — log-log interpolating cost model;
  * :class:`ExecutionPlan`              — the immutable, JSON-cached decision
    table (kernel impl per op × k, chunk/buffer geometry, query bucketing);
  * :mod:`repro_torch.plan.service`     — resolution precedence per device:
    installed plan → $REPRO_TORCH_PLAN_FILE → fingerprint cache → static.

``python -m repro_torch.launch.tune`` measures a plan and caches it.
"""
from repro_torch.plan.fingerprint import cache_dir, device_fingerprint, plan_path
from repro_torch.plan.model import CostModel
from repro_torch.plan.plan import (PLAN_IMPLS, PLAN_OPS, SORTED_MIN_K,
                                   ExecutionPlan, static_impl, static_plan)
from repro_torch.plan.service import (active_plan, clear, install,
                                      planned_engine_config, resolve_impl,
                                      resolve_reduction, use_plan)

__all__ = [
    "PLAN_IMPLS", "PLAN_OPS", "SORTED_MIN_K", "CostModel", "ExecutionPlan",
    "active_plan", "cache_dir", "clear", "device_fingerprint", "install",
    "plan_path", "planned_engine_config", "resolve_impl",
    "resolve_reduction", "static_impl", "static_plan", "use_plan",
]
