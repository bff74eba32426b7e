"""Timed probes over the real dispatch surface — the counterpart of
``repro.plan.probe``.

The PlanService measures the exact entry points the port dispatches
through (``kernels.ops.match_weights`` / ``combine_match`` / ``query`` /
``ingest_window``, and ``StreamRuntime.merged`` per reduction strategy) on
synthetic inputs shaped like real traffic, made from numpy exactly as the
JAX package makes them, so a probe cell is the same data in both
packages. Rows are plain dicts (JSON-ready for the tune record):

  kernel probes     {op, impl, k, c, dtype, time_s}
  reduction probes  {strategy, p, pods, k, time_s}
  publish probes    {op: "publish", k, lanes, chunk, step_s, publish_s,
                     publish_per_step}
  pipeline probes   {op: "pipeline", knob: "coalesce"|"feed"|"publish", ...}

The engine writes a state's buffer in place, so the runtime probes give
every timed ``ingest`` a copy of the warmed state, made before the clock
starts (``timeit``'s ``prepare``): each call starts from the same state,
as each JAX call does, and the warmed state is never written. A reduction
probe at p > 1 runs in a world of p ranks (``launch.mesh.spawn_ranks``),
where every timed call is a collective and the loop counts are rank 0's.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.distributed as dist

#: probe-input id-universe scale: ids are drawn from [0, 4·max(k, c)) so the
#: histogram side can always hold c DISTINCT ids and a minority of ids hit
#: the summary, like steady-state zipf traffic
_ID_SCALE = 4


def agreed_count(n: int) -> int:
    """Rank 0's ``n`` on every rank of the default process group.

    ``n`` itself without a group or in a world of one. A timed loop whose
    calls are collectives must make the same number of calls on every
    rank, and ranks that size their loops from their own clocks disagree.
    """
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return n
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def timeit(fn, *args, repeat: int = 3, min_time: float = 0.25,
           sample_s: float = 2e-3, max_inner: int = 256, prepare=None,
           device=None) -> float:
    """Best-of-``repeat`` per-call time of ``fn(*args)`` on the host clock.

    The clock runs around a loop of calls that ends in a device
    synchronise, so the time includes what a caller pays to dispatch: the
    wrapper's checks, its launches and the PyTorch ops around them (CUDA
    events alone would hide the host work that decides between impls).
    The first call (which builds a kernel) is left out; each sample runs
    an inner loop sized to span ~``sample_s``, and the minimum over the
    samples is kept (noise only adds). A slow cell (≥ ``min_time``) stops
    after two samples.

    ``prepare()``, when given, makes the arguments of one call in place of
    ``args``: every call gets its own, made before its sample's clock
    starts. ``device`` names the device to synchronise where no argument
    is a tensor. Under a process group the inner count and the early stop
    are rank 0's (:func:`agreed_count`), so a collective ``fn`` is called
    equally often on every rank.
    """
    make = prepare or (lambda: args)
    dev = torch.device(device) if device is not None else next(
        (a.device for a in args if isinstance(a, torch.Tensor)), None)

    def sync():
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def sample(n):
        calls = [make() for _ in range(n)]
        sync()
        t0 = time.perf_counter()
        for call in calls:
            fn(*call)
        sync()
        return (time.perf_counter() - t0) / n

    sample(1)                                   # build + warm caches
    t1 = sample(1)                              # calibration run
    inner = agreed_count(max(1, min(max_inner, int(sample_s / max(t1, 1e-9)))))
    best = t1
    for i in range(max(1, repeat)):
        best = min(best, sample(inner))
        if agreed_count(int(best >= min_time and i >= 1)):   # slow cell: stop early
            break
    return best


def timeit_rounds(fns: dict, *args, repeat: int = 3, min_time: float = 0.25,
                  **kw) -> dict:
    """Best-of-``repeat`` time of each ``fns[name](*args)``, in rounds.

    Each round times every fn once (a :func:`timeit` of one sample), so
    the samples of one fn lie apart in time, between the others': a stall
    of the host or the card that outlasts one fn's samples in a single
    :func:`timeit` inflates one sample of each fn here, and the minimum
    drops it. The choice between fns rests on these times. A round in
    which every fn took ``min_time`` or more is the last after the second.
    """
    best: dict = {}
    for i in range(max(1, repeat)):
        for name, fn in fns.items():
            t = timeit(fn, *args, repeat=1, min_time=min_time, **kw)
            best[name] = min(best.get(name, t), t)
        if i >= 1 and min(best.values()) >= min_time:
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
                times = timeit_rounds({impl: functools.partial(entry[op], impl=impl)
                                       for impl in impls}, *args, repeat=repeat)
                for impl, t in times.items():
                    rows.append({"op": op, "impl": impl, "k": int(k), "c": int(c),
                                 "dtype": str(dtype), "time_s": t})
                    emit(f"probe_{op}_{impl}_k{k}_c{c}", f"{t:.4e}")
    return rows


def _warmed(rt, stream):
    """``rt``'s state after ``stream``: the state every timed call starts from."""
    return rt.ingest(rt.init(), stream)


def _copy_state(state):
    """A state whose buffer the engine may write: the warmed one's, copied."""
    from repro_torch.engine.state import SketchState
    return SketchState(state.summary, state.buffer.clone(), state.fill, state.n)


def _runtime(*, k, lanes, chunk, depth, impl, device, **topology):
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    return StreamRuntime(RuntimeConfig(
        engine=EngineConfig(k=k, tenants=lanes, chunk=chunk, buffer_depth=depth,
                            kernel=impl, device=str(device)), **topology))


def reduction_rows(p, strategies, k, lanes, chunk, depth, n, impl, repeat, seed,
                   device) -> list[dict]:
    """The reduction cells at p shards: every rank of a world of p calls it
    (p = 1 needs no world). Rank 0's times are the rows."""
    from repro_torch.data.synthetic import zipf_stream
    rows = []
    for strategy in strategies:
        pods = 2 if (strategy == "hierarchical" and p >= 4 and p % 2 == 0) else 1
        rt = _runtime(k=k, lanes=lanes, chunk=chunk, depth=depth, impl=impl,
                      device=device, shards=p, pods=pods, reduction=strategy)
        stream = zipf_stream(n, 1.1, seed=seed, max_id=10**6)
        state = rt.ingest(rt.init(), stream)
        t = timeit(rt.merged, state, repeat=repeat, device=rt.engine.device)
        rows.append({"strategy": strategy, "p": int(p), "pods": pods, "k": int(k),
                     "time_s": t})
    return rows


def probe_reductions(*, ps=(1, 2, 4), strategies=("butterfly", "allgather",
                                                  "hierarchical"),
                     k: int = 2048, lanes: int = 2, chunk: int = 2048,
                     depth: int = 4, n: int = 1 << 17, impl: str = "torch",
                     repeat: int = 3, seed: int = 0, device="cuda",
                     emit=lambda *a: None) -> list[dict]:
    """Per-strategy snapshot-reduction latency at each probed axis size.

    Drives the real path — ``StreamRuntime.merged`` over an ingested
    sharded state — so the number includes the flush view and the
    strategy's collective rounds, what a serving snapshot pays. p = 1 runs
    here; each p > 1 in a new world of p ranks (gloo on the CPU, nccl and
    one card a rank on CUDA, where ``ps`` is clipped to the card count as
    the JAX package clips it to its devices).
    """
    from repro_torch.launch.mesh import spawn_ranks
    if torch.device(device).type == "cuda":
        ps = [p for p in ps if p <= torch.cuda.device_count()]
    rows = []
    for p in ps:
        cell = (p, tuple(strategies), k, lanes, chunk, depth, n, impl, repeat, seed,
                str(device))
        got = reduction_rows(*cell) if p == 1 else spawn_ranks(p, reduction_rows, *cell,
                                                               device=device)
        for r in got:
            rows.append(r)
            emit(f"probe_reduce_{r['strategy']}_p{p}", f"{r['time_s']:.4e}")
    return rows


def probe_publish(*, ks=(256, 2048), lanes: int = 4, chunk: int = 2048,
                  depth: int = 4, impl: str = "auto", repeat: int = 3,
                  seed: int = 0, device="cuda", emit=lambda *a: None) -> list[dict]:
    """The serving tier's write-path costs: one ingest step vs one publish.

    Per probed counter budget, times the two dispatches the IngestLoop
    alternates between on a warmed single-shard runtime — ``ingest`` of
    one canonical (W, chunk) block (the per-block step) and ``snapshot``
    (flush view + reduction + provenance: the whole price of publishing
    one ring version). Their ratio ``publish_per_step`` is what the tune
    CLI turns into a cadence: publish every ``ceil(ratio / budget)``
    blocks and snapshot overhead stays under ``budget`` of ingest
    throughput (DESIGN.md §11.3).
    """
    from repro_torch.data.synthetic import zipf_stream

    rows = []
    for k in ks:
        rt = _runtime(k=k, lanes=lanes, chunk=chunk, depth=depth, impl=impl,
                      device=device, shards=1)
        dev = rt.engine.device
        rng_seed = seed + 13 * k
        # steady state: fill the summaries before timing, so the probe
        # sees production-shaped merges, not empty-summary fast paths
        warm = zipf_stream(4 * rt.workers * chunk, 1.1, seed=rng_seed, max_id=10**6)
        state = _warmed(rt, warm)
        block = rt.decompose(torch.from_numpy(zipf_stream(
            rt.workers * chunk, 1.1, seed=rng_seed + 1, max_id=10**6)).to(dev))
        step_s = timeit(rt.ingest, prepare=lambda: (_copy_state(state), block),
                        repeat=repeat, device=dev)
        publish_s = timeit(lambda: rt.snapshot(state).summary, repeat=repeat, device=dev)
        ratio = publish_s / max(step_s, 1e-12)
        rows.append({"op": "publish", "k": int(k), "lanes": int(lanes),
                     "chunk": int(chunk), "step_s": step_s,
                     "publish_s": publish_s, "publish_per_step": ratio})
        emit(f"probe_publish_k{k}", f"{publish_s:.4e}",
             f"step={step_s:.3e};ratio={ratio:.2f}")
    return rows


def probe_pipeline(*, k: int = 2048, lanes: int = 4, chunk: int = 2048,
                   depth: int = 4, impl: str = "auto",
                   coalesce=(1, 2, 4, 8), feed_depths=(1, 2, 4),
                   repeat: int = 3, seed: int = 0, device="cuda",
                   emit=lambda *a: None) -> list[dict]:
    """The asynchronous-pipeline knobs, measured on the serving hot loop.

    Three sub-probes on one warmed single-shard runtime (DESIGN.md §13):

      knob="coalesce"  per-block amortized cost of ingesting m canonical
                       blocks as ONE coalesced (W, m·chunk) dispatch —
                       where the dispatch-overhead amortization flattens
                       out is the plan's ``coalesce_max``
      knob="feed"      per-block cost of the feed() loop at each staging
                       depth (the double-buffering payoff curve) —
                       smallest depth within noise of the best wins
      knob="publish"   one eager snapshot vs one ingest step; when the
                       eager publish is a non-trivial fraction of a step
                       the plan turns on ``lazy_publish``
    """
    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.runtime.feed import coalesce_blocks

    geometry = dict(k=k, lanes=lanes, chunk=chunk, depth=depth, impl=impl, device=device)
    rt = _runtime(**geometry, shards=1)
    dev = rt.engine.device
    warm = zipf_stream(4 * rt.workers * chunk, 1.1, seed=seed + 29, max_id=10**6)
    state = _warmed(rt, warm)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rows = []
    payloads = [zipf_stream(rt.workers * chunk, 1.1, seed=seed + 31 + i, max_id=10**6)
                for i in range(max(coalesce))]
    for m in sorted(set(int(m) for m in coalesce if m >= 1)):
        block = on_dev(coalesce_blocks(payloads[:m], rt.workers, chunk))
        t = timeit(rt.ingest, prepare=lambda: (_copy_state(state), block),
                   repeat=repeat, device=dev) / m
        rows.append({"op": "pipeline", "knob": "coalesce", "m": int(m),
                     "k": int(k), "chunk": int(chunk), "block_s": t})
        emit(f"probe_pipeline_coalesce_m{m}", f"{t:.4e}")

    n_blocks = 8
    feed_payloads = [zipf_stream(rt.workers * chunk, 1.1, seed=seed + 61 + i,
                                 max_id=10**6) for i in range(n_blocks)]
    for d in sorted(set(int(d) for d in feed_depths if d >= 1)):
        frt = _runtime(**geometry, shards=1, feed_depth=d)
        fstate = _warmed(frt, warm)
        # feed() ingests into a copy of the caller's buffer: fstate stays warm
        t = timeit(lambda: frt.feed(fstate, feed_payloads), repeat=repeat,
                   device=dev) / n_blocks
        rows.append({"op": "pipeline", "knob": "feed", "depth": int(d),
                     "k": int(k), "block_s": t})
        emit(f"probe_pipeline_feed_d{d}", f"{t:.4e}")

    block = rt.decompose(on_dev(payloads[0]))
    step_s = timeit(rt.ingest, prepare=lambda: (_copy_state(state), block),
                    repeat=repeat, device=dev)
    eager_s = timeit(lambda: rt.snapshot(state).summary, repeat=repeat, device=dev)
    rows.append({"op": "pipeline", "knob": "publish", "k": int(k),
                 "step_s": step_s, "eager_s": eager_s})
    emit("probe_pipeline_publish", f"{eager_s:.4e}", f"step={step_s:.3e}")
    return rows
