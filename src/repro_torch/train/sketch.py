"""Space Saving sketches as first-class serving and training state.

The counterpart of ``repro.train.sketch``: the paper's technique living
inside the LM substrate, on the port's SketchEngine. This module only
adapts model tensors into engine calls; buffering, kernel dispatch and
reductions all live in ``repro_torch.engine``:

  * token sketch — a SketchState with G tenants (G = the plan's batch
    groups, 1 on one process). Every step's tokens are block-decomposed
    over the G groups (the paper's Algorithm 1 decomposition) and go
    through the engine's buffered update path; the merge runs once per
    ``buffer_depth`` chunks.
  * expert sketch — a single-tenant SketchState fed a router's per-step
    expert counts via ``absorb_histogram`` (an exact histogram, so it
    merges directly with m₂ = 0).
  * merge_sketches — the ParallelReduction: the engine's reduction
    strategy over the tenant dim.

Every engine lives on ``device`` (the card unless the caller asks for the
CPU). ``SketchConfig.kernel`` may hold the JAX package's impl names:
``'pallas'`` runs the port's ``'cuda'`` kernels and ``'jnp'`` its
``'torch'`` plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.parallel import block_decompose
from repro_torch.core.spacesaving import Summary
from repro_torch.engine import EngineConfig, SketchEngine, SketchState

# the JAX package's impl names -> the port's (kernels/ops.py)
_PORT_KERNELS = {"pallas": "cuda", "jnp": "torch"}


# ---------------------------------------------------------------------------
# Engine construction from an ArchConfig's SketchConfig
# ---------------------------------------------------------------------------

def token_engine_config(sk_cfg, groups: int, *, chunk: int | None = None,
                        device="cuda") -> EngineConfig:
    """EngineConfig of the token sketch: G tenants, buffered updates.

    ``chunk`` overrides ``sk_cfg.chunk`` for callers whose per-step payload
    is much smaller than the training chunk (the decode loop feeds B tokens
    a step: C-wide slots would make every flush mostly EMPTY padding).
    """
    return EngineConfig(
        k=sk_cfg.k_counters, tenants=groups,
        chunk=chunk if chunk is not None else sk_cfg.chunk,
        buffer_depth=sk_cfg.buffer_depth, flush_mode=sk_cfg.flush_mode,
        reduction=sk_cfg.reduction,
        kernel=_PORT_KERNELS.get(sk_cfg.kernel, sk_cfg.kernel), device=str(device))


def token_engine(sk_cfg, groups: int, *, chunk: int | None = None,
                 device="cuda") -> SketchEngine:
    """The engine behind the token sketch. Engine methods take the
    geometry from the state, so any engine can still serve any state."""
    return SketchEngine(token_engine_config(sk_cfg, groups, chunk=chunk, device=device))


def token_runtime(sk_cfg, groups: int, *, chunk: int | None = None,
                  shards: int = 1, device="cuda"):
    """A StreamRuntime owning the token sketch end to end.

    The serving telemetry holds this instead of a bare engine, getting
    init/snapshot/frontend with shard provenance.
    """
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    return StreamRuntime(RuntimeConfig(
        engine=token_engine_config(sk_cfg, groups, chunk=chunk, device=device),
        shards=shards))


def expert_engine(sk_cfg, *, device="cuda") -> SketchEngine:
    """The engine behind the expert sketch: one tenant, histogram absorbs."""
    return SketchEngine(EngineConfig(
        k=sk_cfg.expert_counters, tenants=1, chunk=sk_cfg.expert_counters,
        buffer_depth=1, flush_mode=sk_cfg.flush_mode, reduction=sk_cfg.reduction,
        kernel=_PORT_KERNELS.get(sk_cfg.kernel, sk_cfg.kernel), device=str(device)))


# ---------------------------------------------------------------------------
# State construction / shapes / shardings
# ---------------------------------------------------------------------------

def init_token_sketch(sk_cfg, groups: int, *, chunk: int | None = None,
                      device="cuda") -> SketchState:
    return token_engine(sk_cfg, groups, chunk=chunk, device=device).init()


def init_expert_sketch(sk_cfg, *, device="cuda") -> SketchState:
    return expert_engine(sk_cfg, device=device).init()


def token_sketch_shapes(sk_cfg, groups: int, *, chunk: int | None = None,
                        device="cuda") -> SketchState:
    return token_engine(sk_cfg, groups, chunk=chunk, device=device).state_shapes()


def expert_sketch_shapes(sk_cfg, *, device="cuda") -> SketchState:
    return expert_engine(sk_cfg, device=device).state_shapes()


def sketch_shardings(plan, shapes: SketchState) -> SketchState:
    """The identity on one process: every leaf stays where it is."""
    return shapes


# ---------------------------------------------------------------------------
# Per-step updates + the ParallelReduction
# ---------------------------------------------------------------------------

def update_token_sketch(engine: SketchEngine, sketch: SketchState,
                        tokens: torch.Tensor) -> SketchState:
    """tokens (B, S): block-decomposed over the G tenants, buffered update.

    The (B·S) stream is split evenly over the G groups (the canonical
    ``block_decompose`` every ingestion surface shares) and fed through the
    engine's deferred-merge path. The engine writes ``sketch``'s buffer in
    place: ``sketch`` must not be used again.
    """
    return engine.ingest(sketch, block_decompose(tokens.reshape(-1), sketch.tenants))


def update_expert_sketch(engine: SketchEngine, sketch: SketchState,
                         expert_counts: torch.Tensor) -> SketchState:
    """expert_counts (E,) int32 — exact histogram, direct merge (m₂ = 0)."""
    e = expert_counts.shape[0]
    items = torch.arange(e, dtype=torch.int32, device=expert_counts.device)
    valid = expert_counts > 0
    return engine.absorb_histogram(
        sketch, torch.where(valid, items, -1),
        torch.where(valid, expert_counts, torch.zeros_like(expert_counts)))


def merge_sketches(engine: SketchEngine, sketch: SketchState) -> Summary:
    """ParallelReduction over the tenant dim via the engine's strategy.

    Pending buffered chunks are included (flush view), so the merged
    summary reflects every ingested item.
    """
    return engine.merged(sketch)
