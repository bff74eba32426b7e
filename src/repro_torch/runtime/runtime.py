"""StreamRuntime — the sharded two-level ingestion runtime.

The counterpart of ``repro.runtime.runtime``, in PyTorch's SPMD idiom:
every rank of the default process group builds the same runtime and makes
the same calls (DESIGN.md §8):

    init()                 this rank's state: ``lanes`` tenants on its device
    decompose(stream)      the canonical (W, per) block decomposition
    ingest(state, stream)  block-decompose + this rank's rows through its engine
    feed(state, blocks)    host blocks staged ahead of the compute (pinned)
    merged(state)          one global Summary via the reduction strategy
    snapshot(state)        immutable versioned QuerySnapshot with per-worker
                           provenance (the QueryService handoff)
    frontend()             a QueryFrontend on the runtime's resolved kernel

Two-level structure, mapped onto the paper's hybrid MPI/OpenMP design:

  * shard level — one rank per shard; the global stream is
    block-decomposed over W = shards × lanes workers and rank r ingests
    rows ``[r·lanes, (r+1)·lanes)``, so the decomposition is the scatter.
    With ``pods > 1`` the ranks form a ``("pod", "data")`` mesh.
  * lane level — inside each shard the engine runs ``lanes`` batched
    sketches (EngineConfig.tenants): the OpenMP threads of the paper,
    merged by the local COMBINE tree before any communication.

Global summaries run the engine's reduction strategy (``butterfly`` /
``allgather`` / ``hierarchical``) over the mesh's process groups. Because
every strategy evaluates the same canonical adjacent-pair COMBINE tree on
rank 0, and ``merged`` hands every rank rank 0's summary, a sharded
runtime's snapshot is bitwise-identical to a single-process SketchEngine
over the same shards×lanes block decomposition (tests/test_torch_distributed.py).

``shards == 1`` is the fast path: no mesh, no collective, and every
strategy degrades to the engine's local tree.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.parallel import block_decompose
from repro_torch.core.spacesaving import Summary
from repro_torch.engine import SketchEngine
from repro_torch.engine.state import SketchState
from repro_torch.launch.mesh import (available_ranks, backend_for, make_host_mesh,
                                     make_mesh_shape)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.feed import DeviceFeed, host_blocks

# feed()'s time-gated history pump (DESIGN.md §14): at most one registry
# sample per interval, regardless of block rate
FEED_SAMPLE_INTERVAL_S = 0.25


class StreamRuntime:
    """Sharded two-level ingestion: one rank per shard × batched engine lanes."""

    def __init__(self, config: RuntimeConfig):
        self.config = config
        have = available_ranks()
        self.shards = config.shards if config.shards is not None else have
        self.pods = config.resolved_pods(self.shards)
        if self.pods > 1 and self.shards % self.pods:
            raise ValueError(
                f"pods ({self.pods}) must divide shards ({self.shards}, "
                f"auto-sized to the world size)")
        if self.shards > have:
            raise ValueError(
                f"StreamRuntime: requested {self.shards} shards but only "
                f"{have} rank(s) are available; lower shards or start more "
                f"ranks (init_process_group's world_size)")
        device = config.engine.torch_device
        if self.shards == 1:
            # single-shard fast path: the engine's lanes are the whole worker
            # set and every reduction strategy degrades to the local tree
            self.mesh, self.rank, axes = None, 0, ()
        else:
            backend = str(dist.get_backend())
            if backend_for(device) not in backend:
                raise ValueError(
                    f"StreamRuntime: the default group's backend {backend!r} "
                    f"does not move {device.type} tensors; init_process_group("
                    f"backend={backend_for(device)!r})")
            if self.pods > 1:
                self.mesh = make_mesh_shape((self.pods, self.shards // self.pods),
                                            ("pod", "data"), device_type=device.type)
                # innermost (intra-pod) dimension first — the reduction
                # registry's convention; ranks are mesh-major
                axes = ("data", "pod")
            else:
                self.mesh = make_host_mesh(n_data=self.shards, device_type=device.type)
                axes = ("data",)
            self.rank = dist.get_rank()
        self.engine = SketchEngine(dataclasses.replace(
            config.engine, reduction=config.resolved_reduction(self.shards),
            axis_names=axes), mesh=self.mesh)
        self._versions = itertools.count(1)

    # -- geometry ------------------------------------------------------------

    @property
    def lanes(self) -> int:
        return self.config.lanes

    @property
    def workers(self) -> int:
        """Total logical workers W = shards × lanes."""
        return self.shards * self.lanes

    @property
    def rows(self) -> slice:
        """This rank's rows of a (W, per) decomposition."""
        return slice(self.rank * self.lanes, (self.rank + 1) * self.lanes)

    def decompose(self, stream) -> torch.Tensor:
        """The canonical (W, per) block decomposition of a global stream."""
        return block_decompose(stream, self.workers, self.config.engine.chunk)

    # -- state construction --------------------------------------------------

    def init(self) -> SketchState:
        """A fresh state of this rank: ``lanes`` tenants on its device."""
        return self.engine.init()

    # -- ingestion -------------------------------------------------------------

    def ingest(self, state: SketchState, stream) -> SketchState:
        """Ingest a global (N,) stream (or pre-decomposed (W, per) blocks).

        Pre-decomposed blocks must come from the canonical decomposition:
        their per-worker length has to be a multiple of the engine chunk.
        Accepting a ragged tail here would silently EMPTY-pad it *inside*
        the pending buffer, shifting every later chunk boundary off the
        canonical single-process decomposition. An empty stream is a no-op.
        A host (numpy) stream is decomposed on the host, and only this
        rank's rows go to the device.
        """
        chunk = self.config.engine.chunk
        if isinstance(stream, torch.Tensor):
            blocks = stream if stream.dim() == 2 else self.decompose(stream)
        else:
            stream = np.asarray(stream)
            blocks = stream if stream.ndim == 2 else host_blocks(stream, self.workers, chunk)
        if blocks.shape[0] != self.workers:
            raise ValueError(
                f"ingest: got {blocks.shape[0]} worker blocks but this "
                f"runtime decomposes over {self.workers} workers "
                f"({self.shards} shards × {self.lanes} lanes); pass a flat "
                f"(N,) stream or use runtime.decompose()")
        if blocks.shape[-1] % chunk:
            raise ValueError(
                f"ingest: per-worker block length {blocks.shape[-1]} is not "
                f"a multiple of the engine chunk ({chunk}); decompose with "
                f"runtime.decompose() / host_blocks(), which EMPTY-pad to "
                f"chunk multiples")
        if blocks.shape[-1] == 0:
            return state
        return self.engine.ingest(state, blocks[self.rows])

    def feed(self, state: SketchState, blocks) -> SketchState:
        """Staged ingestion of an iterable of host stream blocks.

        Each element is one (N,)-shaped host array (numpy); it is
        decomposed on the host, this rank's rows are staged onto the device
        ``feed_depth`` copies ahead of the compute (``DeviceFeed``: pinned
        buffers and a side stream on a CUDA device), and ingested in
        arrival order. The engine writes its buffer in place, so the first
        step writes into a copy of the caller's buffer: ``state`` stays
        valid and unchanged.
        """
        chunk = self.config.engine.chunk
        rows = self.rows
        decomposed = (host_blocks(b, self.workers, chunk) for b in blocks)
        staged = (b[rows] for b in decomposed if b.shape[-1])   # empty → nothing pending
        dev = DeviceFeed(staged, device=self.engine.device,
                         depth=self.config.resolved_feed_depth())
        # process-level obs (DESIGN.md §12): counts + per-block dispatch
        # latency (the cost the feed loop itself pays). The time-gated
        # sample() pump gives batch feeds the ring-buffer histories a
        # sampled registry gets (DESIGN.md §14).
        reg = obs_metrics.DEFAULT
        m_blocks = reg.counter("runtime.feed.blocks")
        m_step = reg.histogram("runtime.feed.step_s")
        state = SketchState(state.summary, state.buffer.clone(), state.fill, state.n)
        next_sample = time.perf_counter() + FEED_SAMPLE_INTERVAL_S
        for block in dev:
            t0 = time.perf_counter()
            state = self.engine.ingest(state, block)
            now = time.perf_counter()
            m_step.record(now - t0)
            m_blocks.inc()
            if now >= next_sample:
                reg.sample(now)
                next_sample = now + FEED_SAMPLE_INTERVAL_S
        return state

    # -- reads -----------------------------------------------------------------

    def merged(self, state: SketchState) -> Summary:
        """One global summary: flush view → lane reduce → mesh reduction.

        Every rank returns rank 0's summary, the canonical tree's.
        """
        s = self.engine.merged(state)
        if self.mesh is None:
            return s
        s = Summary(*(a.contiguous() for a in s))
        for a in s:
            dist.broadcast(a, src=0)
        return s

    def snapshot(self, state: SketchState, *, lazy: bool = False,
                 version: int | None = None, n_hint: int | None = None,
                 on_materialize=None):
        """Publish an immutable versioned QuerySnapshot (QueryService handoff).

        Provenance carries the per-WORKER ingest counts ``shard_n`` ((W,),
        rank-major: which rank×lane saw how much of the stream) and the
        engine-resolved kernel. The ingest buffer is only *viewed*, never
        flushed — ``state`` keeps appending afterwards.

        ``lazy=True`` defers the reduction to the first reader and keeps a
        copy of a partly filled buffer (the engine writes it in place). At
        ``shards > 1`` the reduction is collective, so every rank must
        read a lazy snapshot.
        """
        from repro_torch.service.snapshot import publish_lazy
        if version is None:
            version = next(self._versions)
        obs_metrics.DEFAULT.counter("runtime.snapshot_publishes").inc()
        if not lazy:
            return self._eager_snapshot(state, version)
        if state.fill:
            state = SketchState(state.summary, state.buffer.clone(), state.fill, state.n)
        c = self.engine.config
        return publish_lazy(lambda: self._eager_snapshot(state, version),
                            version=version, kernel=c.resolved_kernel(), k=c.k,
                            n_hint=n_hint, on_materialize=on_materialize)

    def _eager_snapshot(self, state: SketchState, version: int):
        from repro_torch.service.snapshot import publish
        summary = self.merged(state)
        shard_n = state.n
        if self.mesh is not None:
            parts = [torch.empty_like(shard_n) for _ in range(self.shards)]
            dist.all_gather(parts, shard_n.contiguous())
            shard_n = torch.cat(parts)
        return publish(summary, shard_n.sum(), shard_n, version=version,
                       kernel=self.engine.config.resolved_kernel())

    def frontend(self):
        """A QueryFrontend matched to this runtime's resolved kernel."""
        from repro_torch.service import QueryFrontend
        return QueryFrontend.for_engine(self.engine)
