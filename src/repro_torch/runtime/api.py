"""One-shot functional API over StreamRuntime (Algorithm 1 verbatim).

The counterpart of ``repro.runtime.api``. ``parallel_spacesaving`` is the
paper's end-to-end program — block decomposition, per-worker Space Saving,
ParallelReduction — as a single call. It runs on a cached single-shard
runtime whose ``p`` lanes are the logical workers (``buffer_depth=1``
recovers the unbuffered per-chunk merge semantics of the original
formulation). ``frequent_items`` adds the PRUNED k-majority step. Both are
re-exported from ``repro_torch.core``.
"""
from __future__ import annotations

import functools

from repro_torch.core.spacesaving import Summary, prune
from repro_torch.engine import EngineConfig
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.runtime import StreamRuntime


@functools.lru_cache(maxsize=64)
def _oneshot_runtime(k: int, p: int, chunk_size: int, kernel: str,
                     device: str) -> StreamRuntime:
    return StreamRuntime(RuntimeConfig(
        engine=EngineConfig(k=k, tenants=p, chunk=chunk_size, buffer_depth=1,
                            reduction="local", kernel=kernel, device=device),
        shards=1))


def parallel_spacesaving(stream, *, k: int, p: int, chunk_size: int = 1024,
                         kernel: str = "auto", device="cuda") -> Summary:
    """Algorithm 1: local Space Saving per block, then ParallelReduction."""
    rt = _oneshot_runtime(int(k), int(p), int(chunk_size), kernel, str(device))
    return rt.merged(rt.ingest(rt.init(), stream))


def frequent_items(stream, *, k_majority: int, counters: int | None = None,
                   p: int = 1, chunk_size: int = 1024, device="cuda"):
    """End-to-end k-majority query: (items, f̂, candidate, guaranteed).

    ``counters`` defaults to the theory-minimal k (one counter per possible
    heavy hitter); more counters tighten the ε bounds.
    """
    counters = counters or k_majority
    summary = parallel_spacesaving(stream, k=counters, p=p, chunk_size=chunk_size,
                                   device=device)
    return prune(summary, int(stream.shape[-1]), k_majority)
