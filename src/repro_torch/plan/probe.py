"""Timed probes over the real dispatch surface — the counterpart of
``repro.plan.probe``.

The PlanService measures the exact entry points the port dispatches
through (``kernels.ops.match_weights`` / ``combine_match`` / ``query`` /
``ingest_window``) on synthetic inputs shaped like real traffic, made from
numpy exactly as the JAX package makes them, so a probe cell is the same
data in both packages. Rows are plain dicts, ``{op, impl, k, c, dtype,
time_s}``.

The reduction, publish and pipeline probes of the JAX package drive the
sharded runtime and the serving tier, which are not ported yet.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

#: probe-input id-universe scale: ids are drawn from [0, 4·max(k, c)) so the
#: histogram side can always hold c DISTINCT ids and a minority of ids hit
#: the summary, like steady-state zipf traffic
_ID_SCALE = 4


def timeit(fn, *args, repeat: int = 3, min_time: float = 0.25,
           sample_s: float = 2e-3, max_inner: int = 256) -> float:
    """Best-of-``repeat`` per-call time of ``fn(*args)`` on the host clock.

    The clock runs around a loop of calls that ends in a device
    synchronise, so the time includes what a caller pays to dispatch: the
    wrapper's checks, its launches and the PyTorch ops around them (CUDA
    events alone would hide the host work that decides between impls).
    The first call (which builds a kernel) is left out; each sample runs
    an inner loop sized to span ~``sample_s``, and the minimum over the
    samples is kept (noise only adds). A slow cell (≥ ``min_time``) stops
    after two samples.
    """
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)

    def sync():
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(*args)                                   # build + warm caches
    sync()
    t0 = time.perf_counter()
    fn(*args)
    sync()
    t1 = time.perf_counter() - t0               # calibration run
    inner = max(1, min(max_inner, int(sample_s / max(t1, 1e-9))))
    best = t1
    for i in range(max(1, repeat)):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        sync()
        best = min(best, (time.perf_counter() - t0) / inner)
        if best >= min_time and i >= 1:          # slow cell: stop early
            break
    return best


def _probe_inputs(op: str, k: int, c: int, dtype="int32", seed: int = 0,
                  device="cuda"):
    """Synthetic well-formed inputs for one (op, k, c) probe cell."""
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed + 7 * k + c)
    universe = _ID_SCALE * max(k, c)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # a fully occupied summary with distinct ids (the sorted merge-join's
    # contract), counts zipf-ish descending, errors a fraction of counts
    s_items = rng.choice(universe, size=k, replace=False).astype(np.int32)
    counts = np.sort(rng.zipf(1.3, size=k).astype(np.int64))[::-1]
    s_counts = np.minimum(counts, 2**28).astype(np.int32).astype(dtype)
    s_errors = (s_counts // 4).astype(dtype)
    if op == "query":
        queries = rng.integers(0, universe, size=c).astype(np.int32)
        return tuple(map(on, (s_items, s_counts, s_errors, queries)))
    if op == "flush":
        # the window-level merge sees the raw pending window, duplicates and all
        window = np.minimum(rng.zipf(1.3, size=c), universe - 1).astype(np.int32)
        return tuple(map(on, (s_items, s_counts, s_errors, window)))
    # histogram side: exactly c distinct ids
    h_items = rng.choice(universe, size=c, replace=False).astype(np.int32)
    h_weights = rng.integers(1, 100, size=c).astype(np.int32).astype(dtype)
    if op == "update":
        return tuple(map(on, (s_items, h_items, h_weights)))
    # COMBINE carries an error channel on the incoming side too
    return tuple(map(on, (s_items, h_items, h_weights, (h_weights // 4).astype(dtype))))


def entry_points() -> dict:
    """The ops entry point each plan op dispatches through."""
    from repro_torch.kernels import ops as kops
    return {"update": kops.match_weights, "combine": kops.combine_match,
            "query": kops.query, "flush": kops.ingest_window}


def probe_kernels(*, ops=("update", "combine", "query"), impls=("torch", "sorted"),
                  ks=(256, 2048), cs=(512, 2048), dtype="int32", repeat: int = 3,
                  seed: int = 0, device="cuda", emit=lambda *a: None) -> list[dict]:
    """Time every (op × impl × k × c) cell of the dispatch surface on ``device``."""
    entry = entry_points()
    rows = []
    for op in ops:
        for k in ks:
            for c in cs:
                args = _probe_inputs(op, k, c, dtype, seed, device)
                for impl in impls:
                    t = timeit(functools.partial(entry[op], impl=impl), *args,
                               repeat=repeat)
                    rows.append({"op": op, "impl": impl, "k": int(k), "c": int(c),
                                 "dtype": str(dtype), "time_s": t})
                    emit(f"probe_{op}_{impl}_k{k}_c{c}", f"{t:.4e}")
    return rows
