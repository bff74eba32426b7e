"""SketchEngine — batched multi-tenant Space Saving with deferred merges.

The counterpart of ``repro.engine.engine``. One engine owns B concurrent
sketches ("tenants") and the whole update policy:

    update(state, chunk)        append one (B, C) chunk; merge when T are pending
    flush(state)                force the pending window into the summaries
    ingest(state, stream)       pad/chunk a (B, N) stream through the buffer
    absorb_histogram(state, …)  merge an exact histogram directly (m₂ = 0)
    merged(state)               flush view + reduction strategy → one Summary
    top(state, n)               heavy hitters of the merged summary
    estimate(state, queries)    (f̂, lower bound, monitored) per query id
    snapshot(state)             publish an immutable, versioned QuerySnapshot

With ``axis_names`` in its config the engine is one rank of a mesh: its
reduction spans the tenants of every rank, over the process groups of
those mesh dimensions (the ``mesh`` argument, handed over by
``StreamRuntime``), and every rank calls ``merged``/``snapshot`` together.

The process registry counts public, host-initiated ``flush()`` calls
(``engine.flush_calls``; the auto-flushes of ``update``/``ingest`` are not
counted, as in the JAX engine, where they run inside jitted programs) and
published snapshots (``engine.snapshot_publishes``).

State is updated in place where that saves a copy: ``update``, ``flush``
and ``ingest`` write the pending chunks into ``state.buffer`` (and reset it
to EMPTY after a merge), and the state they return shares that buffer. A
state passed to them must therefore not be used again; a lazy snapshot
keeps its own copy of a partly filled buffer for that reason. Summaries and
``n`` are replaced, never written.

Every method returns the same bits as the JAX engine on the same input.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.parallel import axis_groups
from repro_torch.core.spacesaving import (EMPTY, Summary, bounded_estimates,
                                          merge_histogram, pad_stream, sort_summary)
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.reductions import get_reduction
from repro_torch.engine.state import (SketchState, flushed_summary, init_state,
                                      replayed_summary)
from repro_torch.obs import metrics as obs_metrics


class SketchEngine:
    """Stateless orchestrator: all stream state lives in SketchState."""

    def __init__(self, config: EngineConfig, mesh=None):
        self.config = config
        self.device = config.torch_device
        self._match_fn = config.match_fn()
        self._query_fn = config.query_fn()
        # the window-level flush (one ss_ingest launch when 'fused') governs
        # the deferred merge; replay keeps the per-chunk match_fn path, as
        # do absorb_histogram and the COMBINEs of a non-fused reduction
        self._window_fn = (config.window_fn()
                           if config.flush_mode == "deferred" else None)
        self._pair_fn = config.pair_fn()
        self._reduce_fn = get_reduction(config.reduction)
        self._groups = axis_groups(mesh, config.axis_names)
        self._m_flushes = obs_metrics.DEFAULT.counter("engine.flush_calls")
        self._m_snapshots = obs_metrics.DEFAULT.counter("engine.snapshot_publishes")
        self._versions = itertools.count(1)   # per-engine publish counter

    def _ids(self, x) -> torch.Tensor:
        """Stream ids as int32 on the engine's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.asarray(x, dtype=np.int32)).to(self.device)

    def _reduce(self, stacked: Summary) -> Summary:
        return self._reduce_fn(stacked, self._groups, match_fn=self._match_fn,
                               pair_fn=self._pair_fn)

    # -- construction -------------------------------------------------------

    def init(self) -> SketchState:
        c = self.config
        return init_state(c.k, c.tenants, c.buffer_depth, c.chunk, c.dtype,
                          device=self.device)

    # -- updates ------------------------------------------------------------

    def _flush_view(self, state: SketchState) -> Summary:
        """The summaries as if the pending buffer were merged now (pure)."""
        if self.config.flush_mode == "deferred":
            return flushed_summary(state, window_fn=self._window_fn)
        return replayed_summary(state, match_fn=self._match_fn)

    def flush(self, state: SketchState) -> SketchState:
        """Merge the pending window; the buffer is reset to EMPTY in place."""
        self._m_flushes.inc()
        return self._flush(state)

    def _flush(self, state: SketchState) -> SketchState:
        summary = self._flush_view(state)
        state.buffer.fill_(EMPTY)
        return SketchState(summary, state.buffer, 0, state.n)

    def update(self, state: SketchState, chunk) -> SketchState:
        """Append one chunk per tenant; auto-flush when the buffer fills.

        ``chunk`` is (B, c) with c <= C (EMPTY-padded up to C), or (c,)
        when the engine has a single tenant.
        """
        b, t, c = state.buffer.shape
        chunk = self._ids(chunk)
        if chunk.dim() == 1:
            chunk = chunk[None, :]
        if chunk.shape[0] != b or chunk.shape[1] > c:
            raise ValueError(f"chunk {tuple(chunk.shape)} does not fit buffer "
                             f"{tuple(state.buffer.shape)}")
        chunk = pad_stream(chunk, c)
        state.buffer[:, state.fill] = chunk
        appended = SketchState(state.summary, state.buffer, state.fill + 1,
                               state.n + (chunk != EMPTY).sum(-1).to(state.n.dtype))
        return self._flush(appended) if appended.fill >= t else appended

    def ingest(self, state: SketchState, stream) -> SketchState:
        """Feed a whole (B, N) stream through the buffered update path.

        The same state as ``update`` over each C-chunk in turn, written a
        window at a time.
        """
        b, t, c = state.buffer.shape
        stream = self._ids(stream)
        if stream.dim() == 1:
            stream = stream[None, :]
        if stream.shape[0] != b:
            raise ValueError(f"stream {tuple(stream.shape)} has not {b} tenants")
        chunks = pad_stream(stream, c).reshape(b, -1, c)        # (B, nC, C)
        n = state.n + (chunks != EMPTY).sum((1, 2)).to(state.n.dtype)
        state = SketchState(state.summary, state.buffer, state.fill, n)
        j = 0
        while j < chunks.shape[1]:
            m = min(t - state.fill, chunks.shape[1] - j)
            state.buffer[:, state.fill:state.fill + m] = chunks[:, j:j + m]
            state = SketchState(state.summary, state.buffer, state.fill + m, state.n)
            j += m
            if state.fill >= t:
                state = self._flush(state)
        return state

    def absorb_histogram(self, state: SketchState, items, weights) -> SketchState:
        """Merge an EXACT histogram straight into the summaries (m₂ = 0).

        ``items``/``weights`` are (B, E), or (E,) broadcast to all tenants.
        """
        b = state.tenants
        items = self._ids(items)
        weights = torch.as_tensor(weights, device=self.device)
        if items.dim() == 1:
            items = items[None].expand(b, -1)
            weights = weights[None].expand(b, -1)
        summary = merge_histogram(state.summary, items,
                                  weights.to(state.counts.dtype),
                                  match_fn=self._match_fn)
        valid = (items != EMPTY) & (weights > 0)
        n = state.n + torch.where(valid, weights, 0).sum(-1).to(state.n.dtype)
        return SketchState(summary, state.buffer, state.fill, n)

    # -- queries ------------------------------------------------------------

    def merged(self, state: SketchState) -> Summary:
        """One global summary: flush view, then the reduction strategy.

        When ``fill == 0`` the pending buffer is all EMPTY by construction,
        and merging an EMPTY window never changes a summary, so the flush
        view is skipped and only the reduction is paid.
        """
        if state.fill == 0:
            return self._reduce(state.summary)
        return self._reduce(self._flush_view(state))

    def top(self, state: SketchState, n: int = 10):
        """The n heaviest counters of the merged summary; n clamped to [0, k]."""
        s = sort_summary(self.merged(state), ascending=False)
        n = max(0, min(int(n), s.items.shape[-1]))
        return s.items[:n], s.counts[:n]

    def estimate(self, state: SketchState, queries):
        """(f̂, guaranteed lower bound, monitored?) per query id."""
        s = self.merged(state)
        f, eps, mon = self._query_fn(s.items, s.counts, s.errors, self._ids(queries))
        return bounded_estimates(s, f, eps, mon)

    # -- snapshot publishing (the read-side handoff) -------------------------

    def snapshot(self, state: SketchState, *, lazy: bool = False,
                 version: int | None = None, n_hint: int | None = None,
                 on_materialize=None):
        """Publish an immutable, versioned :class:`QuerySnapshot`.

        Built from the pure flush view + the reduction, so the pending
        buffer is visible in the snapshot but ``state`` is not flushed.
        ``lazy=True`` returns a :class:`LazyQuerySnapshot` whose reduction
        runs on the first read; it captures the state with a copy of a
        partly filled buffer, since later updates write the buffer in place.
        """
        from repro_torch.service.snapshot import publish_lazy
        if version is None:
            version = next(self._versions)
        self._m_snapshots.inc()
        if not lazy:
            return self._eager_snapshot(state, version)
        if state.fill:
            state = SketchState(state.summary, state.buffer.clone(), state.fill, state.n)
        c = self.config
        return publish_lazy(lambda: self._eager_snapshot(state, version),
                            version=version, kernel=c.resolved_kernel(), k=c.k,
                            n_hint=n_hint, on_materialize=on_materialize)

    def _eager_snapshot(self, state: SketchState, version: int):
        from repro_torch.service.snapshot import publish
        return publish(self.merged(state), state.n.sum(), state.n, version=version,
                       kernel=self.config.resolved_kernel())
