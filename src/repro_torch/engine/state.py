"""SketchState — the batched, buffered sketch state.

The counterpart of ``repro.engine.state``. Layout (B tenants, k counters,
buffer depth T, chunk size C):

  summary  Summary of (B, k) tensors — the merged per-tenant summaries
  buffer   (B, T, C) int32           — pending stream chunks, EMPTY-padded;
                                       slot t holds the t-th un-merged chunk
  fill     int (on the host)         — buffered chunks not yet merged, so
                                       that the auto-flush test needs no
                                       device sync
  n        (B,) count dtype          — valid items ingested per tenant
                                       (buffered items included)

The engine writes ``buffer`` in place (``SketchEngine.update``/``flush``/
``ingest``); every other field is replaced, never written.

The two flush views never change the state:

  * :func:`flushed_summary`  — 'deferred': one merge of the whole (T·C)
    window per tenant, ``update_chunk(summary, window)``;
  * :func:`replayed_summary` — 'replay': per-chunk merges over all T slots
    in arrival order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.spacesaving import EMPTY, Summary, init_summary, update_chunk


class SketchState(NamedTuple):
    summary: Summary       # (B, k) leaves
    buffer: torch.Tensor   # (B, T, C) int32, written in place by the engine
    fill: int              # buffered chunks not yet merged
    n: torch.Tensor        # (B,) count dtype

    @property
    def items(self) -> torch.Tensor:
        return self.summary.items

    @property
    def counts(self) -> torch.Tensor:
        return self.summary.counts

    @property
    def errors(self) -> torch.Tensor:
        return self.summary.errors

    @property
    def tenants(self) -> int:
        return self.buffer.shape[0]

    @property
    def k(self) -> int:
        return self.summary.items.shape[-1]

    @property
    def depth(self) -> int:
        return self.buffer.shape[1]

    @property
    def chunk(self) -> int:
        return self.buffer.shape[2]


def init_state(k: int, tenants: int, depth: int, chunk: int,
               count_dtype=torch.int32, *, device) -> SketchState:
    return SketchState(
        summary=init_summary(k, count_dtype, device=device, batch=(tenants,)),
        buffer=torch.full((tenants, depth, chunk), EMPTY, dtype=torch.int32,
                          device=device),
        fill=0,
        n=torch.zeros((tenants,), dtype=count_dtype, device=device),
    )


def flushed_summary(state: SketchState, match_fn=None, window_fn=None) -> Summary:
    """Deferred merge: each tenant's whole pending window in ONE merge.

    Equals ``update_chunk(summary_b, buffer_b.reshape(T·C))`` exactly: the
    window histogram is exact, i.e. a zero-error summary, so this is COMBINE
    with m₂ = 0. One batched call over all tenants.

    ``window_fn`` (a ``(Summary (B, k), window (B, T·C)) -> Summary``
    callable, contract of ``EngineConfig.window_fn``) replaces the batched
    ``update_chunk`` wholesale, and ``match_fn`` then goes unused. Both
    paths give the same bits.
    """
    b, t, c = state.buffer.shape
    window = state.buffer.reshape(b, t * c)
    if window_fn is not None:
        return window_fn(state.summary, window)
    return update_chunk(state.summary, window, match_fn=match_fn)


def replayed_summary(state: SketchState, match_fn=None) -> Summary:
    """Per-chunk merge semantics: ``update_chunk`` over every buffer slot."""
    summ = state.summary
    for t in range(state.depth):
        summ = update_chunk(summ, state.buffer[:, t], match_fn=match_fn)
    return summ


# -- carrying state across packages ------------------------------------------

def state_from_numpy(items, counts, errors, buffer, fill, n, *, device) -> SketchState:
    """A state from numpy leaves, e.g. those of the JAX package's SketchState.

    ``items``/``counts``/``errors`` are (B, k), ``buffer`` (B, T, C),
    ``fill`` a scalar and ``n`` (B,); counts, errors and n keep their dtype.
    """
    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    return SketchState(
        summary=Summary(t(items, np.int32), t(counts), t(errors)),
        buffer=t(buffer, np.int32),
        fill=int(np.asarray(fill)),
        n=t(n),
    )


def state_to_numpy(state: SketchState):
    """``(items, counts, errors, buffer, fill, n)`` as numpy (fill an int32 scalar)."""
    def a(x):
        return x.detach().cpu().numpy()
    return (a(state.items), a(state.counts), a(state.errors), a(state.buffer),
            np.int32(state.fill), a(state.n))
