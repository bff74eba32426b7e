"""PlanService — the one decision point behind every "auto" of the port.

The counterpart of ``repro.plan.service``. Resolution precedence for a
device (first hit wins):

  1. an installed plan (``install(plan)`` / ``use_plan(plan)``);
  2. ``$REPRO_TORCH_PLAN_FILE`` — an explicit plan JSON path;
  3. the plan cache (``fingerprint.plan_path``) for the device's
     fingerprint — written by ``python -m repro_torch.launch.tune``;
  4. :func:`repro_torch.plan.plan.static_plan` — the zero-measurement rule.

One torch process reaches the CPU and the card, where a JAX process had
one backend, so every lookup names its device, and a plan of 1. or 2.
applies only to the device type its fingerprint names: for any other
device type resolution goes on as if it were not there. A plan measured on
the card therefore never routes a CPU tensor; a plan that routes a CPU
tensor to ``'cuda'`` is a fault and :func:`resolve_impl` raises.

A pinned file that does not load raises. A cached plan whose fingerprint
does not match the device is ignored, and a malformed one falls back to
the static plan. Loaded files are cached per (path, mtime), failed loads
too, so a lookup costs a stat, not a parse.
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

from repro_torch.plan.fingerprint import device_fingerprint, plan_path
from repro_torch.plan.plan import ExecutionPlan, static_plan

_installed: ExecutionPlan | None = None
_file_cache: dict = {}     # path -> (mtime_ns, ExecutionPlan | None)
_generation = 0            # bumps whenever resolution answers may change


def generation() -> int:
    """Monotonic counter of plan-state changes (install/clear bump it).

    Memos of resolution answers (``kernels.ops.resolve_impl``) key their
    validity on it.
    """
    return _generation


def install(plan: ExecutionPlan | None) -> None:
    """Pin ``plan`` as the active plan of its device type (None clears)."""
    global _installed, _generation
    _installed = plan
    _generation += 1


def clear() -> None:
    """Drop the installed plan and every cached file load."""
    install(None)
    _file_cache.clear()


@contextlib.contextmanager
def use_plan(plan: ExecutionPlan):
    """Scoped :func:`install` — restores the previous plan on exit."""
    prev = _installed
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def _load(path: Path) -> ExecutionPlan | None:
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        return None
    key = str(path)
    hit = _file_cache.get(key)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        plan = ExecutionPlan.load(path)
    except (ValueError, KeyError, TypeError, AttributeError, OSError):
        plan = None     # malformed or stale-format cache → fallback, not crash
    _file_cache[key] = (mtime, plan)
    return plan


def active_plan(device="cuda") -> ExecutionPlan:
    """The plan every "auto" on ``device`` resolves through."""
    dev_type = torch.device(device).type
    if _installed is not None and _installed.device_type == dev_type:
        return _installed
    env = os.environ.get("REPRO_TORCH_PLAN_FILE")
    if env:
        plan = _load(Path(env))
        if plan is None:
            # a pinned plan says THIS configuration was validated; serving
            # another on a typo'd path or a truncated deploy is refused
            raise ValueError(
                f"$REPRO_TORCH_PLAN_FILE={env!r} is missing or not a valid plan "
                f"JSON; unset it to fall back to the plan cache / static rule")
        if plan.device_type == dev_type:
            return plan
    fp = device_fingerprint(device)
    plan = _load(plan_path(fp))
    if plan is not None and plan.fingerprint == fp:
        return plan
    return static_plan(fp)


def resolve_impl(op: str, k: int, device="cuda", *,
                 plan: ExecutionPlan | None = None) -> str:
    """Collapse one "auto" for ``op`` at counter budget ``k`` on ``device``."""
    impl = (plan or active_plan(device)).impl_for(op, int(k))
    if impl == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(f"the plan routes {op!r} at k={k} to 'cuda' for a "
                         f"{torch.device(device).type} tensor")
    return impl


def resolve_reduction(p: int, device="cuda", *,
                      plan: ExecutionPlan | None = None) -> str:
    """Collapse reduction='auto' to a registry strategy for a p-wide axis."""
    return (plan or active_plan(device)).reduction_for(int(p))


def planned_engine_config(k: int, *, device="cuda",
                          plan: ExecutionPlan | None = None, **overrides):
    """An EngineConfig on the plan's chunk / buffer geometry for ``device``.

    Kernel and reduction stay as the overrides say (default ``'auto'``,
    resolved through the same plan).
    """
    from repro_torch.engine.config import EngineConfig
    p = plan or active_plan(device)
    kw = dict(k=k, chunk=p.chunk, buffer_depth=p.buffer_depth, device=str(device))
    kw.update(overrides)
    return EngineConfig(**kw)
