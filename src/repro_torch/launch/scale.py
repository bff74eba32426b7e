"""The paper's scaling study on StreamRuntime — strong/weak speedup curves.

The counterpart of ``repro.launch.scale``. For every (p, reduction
strategy, kernel impl) cell a sharded StreamRuntime ingests the stream
(the local pass) and produces a global snapshot (the ParallelReduction),
timed separately. Strong scaling fixes the total stream; weak scaling
fixes the per-shard stream. Speedup and efficiency are reported against
the smallest-p runtime of the same (strategy, impl), and every strong cell
is checked bitwise against one SketchEngine over all p·lanes tenants of
the same block decomposition.

A world size is fixed per process group, so each p runs in a world of its
own: p = 1 in this process, each p > 1 in p new processes
(``launch.mesh.spawn_ranks``: gloo on the CPU, nccl and one card a rank on
CUDA, so a one-card host sweeps p = 1 only). Every rank of a world makes
the same calls; rank 0's clock, stopped after a barrier, times each cell,
and rank 0's snapshot is held against the single-process engine. The
parent gathers the cells and computes speedup and efficiency.

Results go to ``BENCH_scaling_torch.json`` (and the same
``name,value,derived`` CSV as the other harnesses). ``--check`` turns
violations — sharded ≠ single-process, or NaN/zero efficiency — into a
nonzero exit.

  python -m repro_torch.launch.scale --check                  # on the card(s)
  python -m repro_torch.launch.scale --device cpu --quick --check
  python -m repro_torch.launch.scale --device cpu --p 1,2,4 --strategies butterfly
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

STRATEGIES = ("butterfly", "allgather", "hierarchical")


def _timeit(fn, make_args, *, repeat, device):
    """Best-of-``repeat`` time of one call ``fn(*make_args())``.

    The arguments are made before the clock starts (``ingest`` writes its
    state's buffer in place, so each call gets a fresh state); the first
    call, which builds kernels, is left out. In a world of several ranks a
    barrier starts and ends each call, so rank 0's clock covers every rank.
    """
    group = dist.is_available() and dist.is_initialized()

    def once():
        args = make_args()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if group:
            dist.barrier()
        t0 = time.perf_counter()
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if group:
            dist.barrier()
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(max(1, repeat)))


def _pods_for(strategy: str, p: int) -> int:
    """hierarchical exercises the two-level ("pod","data") topology when
    the shard count can split into 2 pods; every other strategy (and small
    p) runs the flat single-pod mesh."""
    return 2 if (strategy == "hierarchical" and p >= 4 and p % 2 == 0) else 1


def _single_host_snapshot(stream, *, workers, k, chunk, depth, impl, device):
    """The bitwise reference: one SketchEngine over all p·lanes tenants."""
    from repro_torch.core.parallel import block_decompose
    from repro_torch.engine import EngineConfig, SketchEngine

    eng = SketchEngine(EngineConfig(k=k, tenants=workers, chunk=chunk,
                                    buffer_depth=depth, reduction="local",
                                    kernel=impl, device=str(device)))
    state = eng.ingest(eng.init(), block_decompose(stream, workers, chunk))
    return eng.snapshot(state)


def _snapshots_equal(a, b) -> bool:
    same = all(torch.equal(x, y) for x, y in zip(a.summary, b.summary))
    return same and int(a.n) == int(b.n)


def sweep_cells(p, max_p, strategies, impls, n, k, lanes, chunk, depth, repeat,
                modes, seed, max_id, device) -> list[dict]:
    """Every (impl, mode, strategy) cell at p shards.

    Every rank of a world of p calls it (p = 1 needs no world); the cells
    hold rank 0's times and, in strong mode, whether rank 0's snapshot
    equals the single-process engine's.
    """
    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import RuntimeConfig, StreamRuntime

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    n_weak_per = max(chunk * lanes, n // max_p)

    def on_dev(a):
        return torch.from_numpy(a).to(device)

    stream_strong = on_dev(zipf_stream(n, 1.1, seed=seed, max_id=max_id)) \
        if "strong" in modes else None
    stream_weak = on_dev(zipf_stream(n_weak_per * p, 1.1, seed=seed + 1, max_id=max_id)) \
        if "weak" in modes else None
    cells = []
    for impl in impls:
        reference = None        # depends on (p, impl) only: one per impl
        for mode in modes:
            for strategy in strategies:
                rt = StreamRuntime(RuntimeConfig(
                    engine=EngineConfig(k=k, tenants=lanes, chunk=chunk, buffer_depth=depth,
                                        kernel=impl, device=str(device)),
                    shards=p, pods=_pods_for(strategy, p), reduction=strategy))
                stream = stream_strong if mode == "strong" else stream_weak
                blocks = rt.decompose(stream)
                t_ingest = _timeit(rt.ingest, lambda: (rt.init(), blocks), repeat=repeat,
                                   device=device)
                state = rt.ingest(rt.init(), blocks)
                t_reduce = _timeit(rt.merged, lambda: (state,), repeat=repeat,
                                   device=device)
                total = t_ingest + t_reduce
                n_mode = int(stream.numel())
                cell = {"mode": mode, "p": p, "pods": _pods_for(strategy, p),
                        "strategy": strategy, "impl": impl, "n": n_mode,
                        "ingest_s": t_ingest, "reduce_s": t_reduce, "total_s": total,
                        "items_per_s": n_mode / total}
                if mode == "strong":
                    snap = rt.snapshot(state)        # collective: every rank
                    if rank0:
                        if reference is None:
                            reference = _single_host_snapshot(
                                stream, workers=rt.workers, k=k, chunk=chunk,
                                depth=depth, impl=impl, device=device)
                        cell["equivalent"] = _snapshots_equal(snap, reference)
                cells.append(cell)
    return cells


def run_sweep(*, ps, strategies, impls, n, k, lanes, chunk, depth,
              repeat=3, modes=("strong", "weak"), seed=0, max_id=10**6,
              device="cuda", emit=lambda *a: None) -> dict:
    """The sweep's record: every cell, the reduction latencies, the summary."""
    dev_type = torch.device(device).type
    max_p = max(ps)
    if dev_type == "cuda" and torch.cuda.device_count() < max_p:
        raise RuntimeError(f"scaling sweep needs {max_p} cards, have "
                           f"{torch.cuda.device_count()}")
    from repro_torch.launch.mesh import spawn_ranks

    n_weak_per = max(chunk * lanes, n // max_p)
    cells = []
    for p in ps:
        world = (p, max_p, tuple(strategies), tuple(impls), n, k, lanes, chunk, depth,
                 repeat, tuple(modes), seed, max_id, str(device))
        got = sweep_cells(*world) if p == 1 else spawn_ranks(p, sweep_cells, *world,
                                                             device=device)
        for c in got:
            emit(f"scale_{c['mode']}_{c['strategy']}_{c['impl']}_p{p}",
                 f"{c['total_s']:.4e}",
                 f"ingest={c['ingest_s']:.3e};reduce={c['reduce_s']:.3e}")
        cells += got
    # the JAX record's order: impl, mode, strategy, p
    cells.sort(key=lambda c: (list(impls).index(c["impl"]), list(modes).index(c["mode"]),
                              list(strategies).index(c["strategy"]), c["p"]))
    reduction_latency = {impl: {s: {} for s in strategies} for impl in impls}
    for c in cells:
        if c["mode"] == "strong":
            reduction_latency[c["impl"]][c["strategy"]][str(c["p"])] = c["reduce_s"]

    # speedup/efficiency against the smallest-p cell of the same series
    p_base = min(ps)
    by_series = {}
    for c in cells:
        by_series.setdefault((c["mode"], c["strategy"], c["impl"]), {})[c["p"]] = c
    for c in cells:
        base = by_series[(c["mode"], c["strategy"], c["impl"])][p_base]
        ratio = base["total_s"] / c["total_s"]
        if c["mode"] == "strong":
            c["speedup"] = ratio * p_base
            c["efficiency"] = c["speedup"] / c["p"]
        else:   # weak: per-shard work constant → the ratio IS the efficiency
            c["speedup"], c["efficiency"] = ratio * c["p"], ratio
        emit(f"scale_{c['mode']}_{c['strategy']}_{c['impl']}_p{c['p']}_eff",
             f"{c['efficiency']:.3f}", f"speedup={c['speedup']:.3f}")

    equiv = [c["equivalent"] for c in cells if "equivalent" in c]
    effs = [c["efficiency"] for c in cells]
    return {
        "config": {
            "n_strong": int(n), "n_weak_per_shard": int(n_weak_per),
            "k": k, "lanes": lanes, "chunk": chunk, "buffer_depth": depth,
            "ps": list(ps), "strategies": list(strategies),
            "impls": list(impls), "repeat": repeat,
            "backend": dev_type,
            "devices": torch.cuda.device_count() if dev_type == "cuda" else max_p,
        },
        "cells": cells,
        "reduction_latency_s": reduction_latency,
        "summary": {
            # None (JSON null) when no strong cells ran — equivalence is
            # only defined for strong mode
            "all_equivalent": all(equiv) if equiv else None,
            "min_efficiency": min(effs) if effs else float("nan"),
            "max_speedup": max(c["speedup"] for c in cells) if cells else float("nan"),
        },
    }


def check_record(record: dict) -> list[str]:
    """The gate: equivalence must hold, efficiency must be a number > 0."""
    failures = []
    for c in record["cells"]:
        tag = f"{c['mode']}/{c['strategy']}/{c['impl']}/p{c['p']}"
        if c.get("equivalent") is False:
            failures.append(f"{tag}: sharded snapshot != single-host engine")
        eff = c.get("efficiency", float("nan"))
        if not math.isfinite(eff) or eff <= 0:
            failures.append(f"{tag}: efficiency {eff!r} is NaN/zero")
    if record["summary"]["all_equivalent"] is False:
        failures.append("summary: not all strong-scaling cells equivalent")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the shards run: cuda (default, one card a rank) or cpu")
    ap.add_argument("--p", default=None,
                    help="comma list of shard counts (default 1,2,4,8 on the CPU; "
                         "on CUDA the powers of two up to the card count)")
    ap.add_argument("--strategies", default=",".join(STRATEGIES))
    ap.add_argument("--kernels", default=None,
                    help="comma list of impls (default auto,cuda on the card, "
                         "torch,sorted on the CPU)")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="total stream length (strong scaling)")
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=2,
                    help="engine lanes per shard (the OpenMP level)")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=4, help="engine buffer depth T")
    ap.add_argument("--modes", default="strong,weak")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="smoke sizes (n=65k, k=256, chunk=512)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless equivalence + efficiency gates hold")
    ap.add_argument("--out", default="BENCH_scaling_torch.json")
    args = ap.parse_args(argv)

    if args.quick:
        args.n, args.k, args.chunk, args.depth = 1 << 16, 256, 512, 2
        args.repeat = 2
    on_cuda = torch.device(args.device).type == "cuda"
    if args.p is None:
        cards = torch.cuda.device_count() if on_cuda else 8
        args.p = ",".join(str(1 << i) for i in range(max(cards, 1).bit_length()))
    kernels = args.kernels or ("auto,cuda" if on_cuda else "torch,sorted")

    print("name,value,derived")

    def emit(name, value, derived=""):
        print(f"{name},{value},{derived}", flush=True)

    record = run_sweep(
        ps=sorted({int(p) for p in args.p.split(",")}),
        strategies=[s.strip() for s in args.strategies.split(",")],
        impls=[i.strip() for i in kernels.split(",")],
        n=args.n, k=args.k, lanes=args.lanes, chunk=args.chunk,
        depth=args.depth, repeat=args.repeat, seed=args.seed,
        modes=tuple(m.strip() for m in args.modes.split(",")),
        device=args.device, emit=emit)

    Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    emit("scaling_json", args.out, "written")
    s = record["summary"]
    emit("all_equivalent", s["all_equivalent"])
    emit("min_efficiency", f"{s['min_efficiency']:.3f}")
    emit("max_speedup", f"{s['max_speedup']:.3f}")

    if args.check:
        failures = check_record(record)
        if failures:
            for f in failures:
                print(f"CHECK FAILED: {f}", file=sys.stderr)
            return 1
        print("check,ok,equivalence + efficiency gates hold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
