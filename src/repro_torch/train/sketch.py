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
    """DTensor placements of a SketchState on ``plan``'s mesh: the tenant
    dim of the summary leaves, the pending buffer (G, T, C) and ``n`` on
    the batch axes; ``fill`` (a host int, the same on every rank)
    replicated. Without a mesh, ``shapes`` as they are (every leaf stays
    where it is)."""
    if plan.mesh is None:
        return shapes
    from repro_torch.sharding.rules import placements

    def shard(leaf):
        return placements((plan.batch_axes,) + (None,) * (leaf.dim() - 1), plan.mesh)

    return SketchState(summary=Summary(*(shard(leaf) for leaf in shapes.summary)),
                       buffer=shard(shapes.buffer), fill=placements((), plan.mesh),
                       n=shard(shapes.n))


def distribute_sketch(plan, sketch: SketchState) -> SketchState:
    """``sketch`` (whole, the same on every rank) as DTensors placed by
    :func:`sketch_shardings`; ``fill`` stays the host int."""
    from torch.distributed.tensor import distribute_tensor
    pl = sketch_shardings(plan, sketch)
    put = lambda t, p: distribute_tensor(t, plan.mesh, p, src_data_rank=None)  # noqa: E731
    return SketchState(summary=Summary(*(put(t, p) for t, p in zip(sketch.summary,
                                                                  pl.summary))),
                       buffer=put(sketch.buffer, pl.buffer), fill=sketch.fill,
                       n=put(sketch.n, pl.n))


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

    A sketch of DTensors (:func:`distribute_sketch`) is updated shard by
    shard, as the JAX package's GSPMD program computes it: each rank feeds
    its rows of ``tokens`` (a DTensor, redistributed to the sketch's
    placements: the batch on the batch axes) into its group's tenant through the engine, on
    plain local tensors, so the kernels launch as they do on one process.
    Block g of the global decomposition is exactly group g's rows when
    B % G == 0. A batch of fewer rows than that (long_500k's decode of one
    row) is decomposed whole, the same on every rank, and each rank takes
    its group's block. The ranks along the other mesh axes hold the same
    group and compute the same update.
    """
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(sketch.n, DTensor):
        return engine.ingest(sketch, block_decompose(tokens.reshape(-1), sketch.tenants))
    mesh, groups = sketch.n.device_mesh, sketch.n.shape[0]
    if tokens.shape[0] % groups == 0:
        rows = tokens.redistribute(mesh, sketch.n.placements).to_local()
    else:
        whole = tokens.full_tensor() if isinstance(tokens, DTensor) else tokens
        blocks = DTensor.from_local(block_decompose(whole.reshape(-1), groups), mesh,
                                    [Replicate()] * mesh.ndim, run_check=False)
        rows = blocks.redistribute(mesh, sketch.n.placements).to_local()
    local = SketchState(Summary(*(t.to_local() for t in sketch.summary)),
                        sketch.buffer.to_local(), sketch.fill, sketch.n.to_local())
    assert local.tenants == 1, local.tenants
    out = engine.ingest(local, block_decompose(rows.reshape(-1), 1))

    def wrap(t, like):
        return DTensor.from_local(t, mesh, like.placements, shape=like.shape,
                                  stride=like.stride())
    return SketchState(Summary(*(wrap(t, like) for t, like in zip(out.summary,
                                                                  sketch.summary))),
                       wrap(out.buffer, sketch.buffer), out.fill, wrap(out.n, sketch.n))


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
