"""Autotuning CLI of the port — probe the dispatch surface, make a plan, gate it.

The counterpart of ``repro.launch.tune``. It times the real dispatch
surface (the update / combine / query / flush ops per impl × k × chunk,
every reduction strategy at each probed axis size, and the serving tier's
write path — ``repro_torch.plan.probe``) on one device type, fits the
interpolating cost model, makes an ExecutionPlan, and

  * writes the plan to the fingerprint-keyed plan cache
    (``$REPRO_TORCH_PLAN_CACHE``, or ``--cache-dir``), after which every
    ``'auto'`` on that device type (``ops``, ``EngineConfig``,
    ``RuntimeConfig``, ``ServeConfig``, ``QueryFrontend``) resolves
    through it — only after the gates hold;
  * writes a JSON record (``--out``): the raw probe times, the plan, the
    model's predicted-vs-measured error on held-out cells and the gate
    margins;
  * with ``--check``, exits 1 unless (a) a fresh re-measurement of every
    planned choice is within ``--tolerance`` of the best impl of its cell
    (the static impl is always among those measured) and (b) ``'auto'``
    under the plan gives the same bits as every impl, at each op and
    through the engine.

``publish`` and ``pipeline`` in ``--ops`` are not kernel-table ops: they
time the serving tier's write path and set the plan's cadence
(``publish_every``, ``ring_depth``) and pipeline knobs (``coalesce_max``,
``feed_depth``, ``lazy_publish``). The reduction probes time
``StreamRuntime.merged`` per strategy at each ``--p``: p = 1 in this
process, each p > 1 in a new world of p ranks (gloo on the CPU; on a CUDA
device one card a rank, and ``--p`` is clipped to the card count, so a
one-card host probes p = 1 only and its plan has no reduction table).

  python -m repro_torch.launch.tune --check                     # on the card
  python -m repro_torch.launch.tune --device cpu --quick --check \\
      --cache-dir /tmp/plans --out /tmp/BENCH_plan_torch.json
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import platform
import sys
import time
from pathlib import Path

import torch

from repro_torch.plan import probe

#: kernel-table ops probed by default: 'combine' drives every engine merge,
#: 'query' every read and 'flush' the window-level merge where the fused
#: kernel competes; 'update' (ops.match_weights) is probed on demand via --ops
OPS = ("combine", "query", "flush")
KERNEL_OPS = ("update",) + OPS
#: not kernel-table ops: 'publish' times the serving tier's write-path pair
#: (one ingest step vs one snapshot publish) and the plan records a CADENCE
#: (publish_every / ring_depth); 'pipeline' measures the async-ingestion
#: knobs (coalesce_max / feed_depth / lazy_publish, DESIGN.md §13)
SERVING_OPS = ("publish", "pipeline")
DEFAULT_OPS = OPS + SERVING_OPS
STRATEGIES = ("butterfly", "allgather", "hierarchical")

#: snapshot publishes may cost at most this fraction of ingest
#: throughput at the planned cadence (the serving tier's SLO input)
PUBLISH_BUDGET = 0.1


def _choose_publish(rows, budget: float = PUBLISH_BUDGET) -> tuple[int, int]:
    """(publish_every, ring_depth) from the measured step/publish costs.

    Cadence: publishing every ``ceil(ratio / budget)`` ingested blocks
    caps snapshot overhead at ``budget`` of ingest throughput, where
    ``ratio`` is publish-cost / step-cost at the largest probed k (publish
    cost grows with k, so the widest cell is the binding one). Clamped to
    [1, 256].

    Ring depth: a reader that pinned ``latest`` must still find it after
    the publishes that complete while its answer materializes — one
    publish takes ``ratio`` steps, during which at most
    ``ceil(ratio / publish_every)`` newer versions can land. Two slots of
    slack on top (the in-flight publish and the pinned read), clamped to
    [2, 16].
    """
    if not rows:
        return 8, 4
    row = max(rows, key=lambda r: r["k"])
    ratio = row["publish_per_step"]
    publish_every = max(1, min(256, math.ceil(ratio / budget)))
    ring_depth = max(2, min(16, 2 + math.ceil(ratio / publish_every)))
    return publish_every, ring_depth


#: a pipeline knob value within this fraction of the best probed cell is
#: "as good": the SMALLEST such value wins (less queueing delay / memory)
PIPELINE_SLACK = 0.02

#: lazy publishing pays off once an eager publish costs more than this
#: fraction of one ingest step
LAZY_PUBLISH_MIN_RATIO = 0.05


def _choose_pipeline(rows) -> tuple[int, int, bool]:
    """(coalesce_max, feed_depth, lazy_publish) from the pipeline probes.

    Coalescing and staging depth both trade latency/memory for amortized
    dispatch overhead, so each knob takes the SMALLEST probed value whose
    per-block cost is within ``PIPELINE_SLACK`` of the best cell.
    ``lazy_publish`` turns on when the measured eager publish is more than
    ``LAZY_PUBLISH_MIN_RATIO`` of one ingest step.
    """
    coalesce_max, feed_depth, lazy = 1, 2, False
    co = {r["m"]: r["block_s"] for r in rows if r.get("knob") == "coalesce"}
    if co:
        best = min(co.values())
        coalesce_max = min(m for m, t in co.items()
                           if t <= (1.0 + PIPELINE_SLACK) * best)
    fe = {r["depth"]: r["block_s"] for r in rows if r.get("knob") == "feed"}
    if fe:
        best = min(fe.values())
        feed_depth = min(d for d, t in fe.items()
                         if t <= (1.0 + PIPELINE_SLACK) * best)
    pub = [r for r in rows if r.get("knob") == "publish"]
    if pub:
        r = pub[-1]
        lazy = r["eager_s"] > LAZY_PUBLISH_MIN_RATIO * max(r["step_s"], 1e-12)
    return int(coalesce_max), int(feed_depth), bool(lazy)


def _choose_reductions(rows) -> tuple[dict, dict]:
    """({p: strategy}, {p: pods}) for every probed p > 1: the fastest cell,
    ties to the strategy name (p = 1 needs no table: every strategy is the
    local tree there)."""
    by_p: dict = {}
    for r in rows:
        by_p.setdefault(r["p"], []).append(r)
    reductions, pods = {}, {}
    for p, cells in by_p.items():
        best = min(cells, key=lambda r: (r["time_s"], r["strategy"]))
        if p > 1:
            reductions[p] = best["strategy"]
            pods[p] = best["pods"]
    return reductions, pods


def _impls_for_op(op: str, impls) -> list[str]:
    """The impl list probed and gated at one op's dispatch surface.

    The fused kernel exists only at the window-level 'flush' surface, and
    it is always probed there, whatever --kernels says: a measurement is
    its only way into a plan.
    """
    if op == "flush":
        return list(dict.fromkeys([*impls, "fused"]))
    return list(impls)


def _midpoints(ks) -> list[int]:
    """Geometric midpoints of adjacent probed budgets (held-out cells)."""
    ks = sorted(ks)
    return [int(round(math.sqrt(a * b))) for a, b in zip(ks, ks[1:])
            if int(round(math.sqrt(a * b))) not in ks]


def _choose_chunk(model, op_ks, cs) -> int:
    """The probed chunk with the lowest per-item combine cost at the largest k."""
    k_ref = max(op_ks)
    best = min(cs, key=lambda c: min(
        model.predict("combine", i, k_ref, c)
        for i in model.impls_for("combine")) / c)
    return int(best)


def _choose_query_min_batch(rows, chunk) -> int:
    """Largest probed query batch still in the launch-overhead plateau.

    The largest c of the dedicated small-batch query probes whose best
    time is within 25% of the smallest batch's, clamped to [8, 256] and
    below the chunk.
    """
    by_c: dict = {}
    for r in rows:
        if r["op"] == "query":
            t = by_c.get(r["c"])
            by_c[r["c"]] = min(t, r["time_s"]) if t is not None else r["time_s"]
    if not by_c:
        return 16
    c_min = min(by_c)
    plateau = [c for c, t in by_c.items() if t <= 1.25 * by_c[c_min]]
    return int(max(8, min(256, chunk, max(plateau, default=c_min))))


def gate_cell(op: str, k: int, c: int, planned: str, static: str, fresh: dict,
              tolerance: float) -> tuple[dict, str | None]:
    """The tolerance decision at one gate cell, from the fresh times alone.

    ``fresh`` maps each impl measured at the cell to its time. The planned
    impl passes when it is at most ``tolerance`` slower than the best of
    them. Returns the record row and the failure message (None on a pass).
    """
    best = min(fresh.values())
    row = {"op": op, "k": k, "c": c, "planned": planned, "fresh_s": fresh,
           "best_fresh_s": best, "static_impl": static,
           "static_fresh_s": fresh[static],
           "margin": fresh[planned] / best if best else 1.0}
    failure = None
    if fresh[planned] > (1.0 + tolerance) * best:
        failure = (f"{op}/k{k}: planned {planned} at {fresh[planned]:.3e}s exceeds "
                   f"best fresh impl at {best:.3e}s by more than {tolerance:.0%}")
    return row, failure


def _bitwise_gate(plan, impls, emit, *, seed: int = 0, ops=OPS, device="cuda") -> dict:
    """Plan-resolved 'auto' ≡ every impl, per op AND through the engine."""
    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig, SketchEngine
    from repro_torch.plan import use_plan

    entry = probe.entry_points()

    def same(a, b):
        if a is None or b is None:
            return a is b
        return torch.equal(a, b)

    stream = zipf_stream(20_000, 1.2, seed=seed, max_id=10**5).reshape(2, -1)

    def snap(kernel):
        eng = SketchEngine(EngineConfig(k=256, tenants=2, chunk=512, buffer_depth=2,
                                        kernel=kernel, device=str(device)))
        return eng.snapshot(eng.ingest(eng.init(), stream))

    results = {}
    with use_plan(plan):
        for op in ops:
            args = probe._probe_inputs(op, 256, 512, "int32", seed, device)
            ref = entry[op](*args, impl="auto")
            for impl in _impls_for_op(op, impls):
                out = entry[op](*args, impl=impl)
                key = f"{op}:{impl}"
                results[key] = all(same(a, b) for a, b in zip(ref, out, strict=True))
                emit(f"bitwise_{op}_auto_vs_{impl}", str(results[key]).lower())
        ref_snap = snap("auto")
        engine_impls = _impls_for_op("flush", impls) if "flush" in ops else list(impls)
        for impl in engine_impls:
            s = snap(impl)
            ok = all(same(a, b) for a, b in zip(ref_snap.summary, s.summary))
            results[f"engine:{impl}"] = ok and int(ref_snap.n) == int(s.n)
            emit(f"bitwise_engine_auto_vs_{impl}", str(results[f"engine:{impl}"]).lower())
    return results


def resolution_timing(emit, *, reps: int = 200, cache_dir=None, device="cuda") -> dict:
    """Time plan resolution: the cold cache load and warm per-op resolves.

    ``plan_resolution_<op>`` is the unmemoized PlanService path (a cache
    stat and a table lookup), ``plan_resolution_<op>_memo`` the
    ``kernels.ops.resolve_impl`` memo hit every later dispatch pays.
    ``cache_dir`` points resolution at the cache this run just wrote.
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.plan import active_plan, clear, resolve_impl

    prev = os.environ.get("REPRO_TORCH_PLAN_CACHE")
    if cache_dir is not None:
        os.environ["REPRO_TORCH_PLAN_CACHE"] = str(cache_dir)
    clear()
    try:
        t0 = time.perf_counter()
        source = active_plan(device).source
        cold_s = time.perf_counter() - t0
        timing = {"cold_load_s": cold_s, "source": source}
        for op in OPS:
            t0 = time.perf_counter()
            for _ in range(reps):
                resolve_impl(op, 1024, device)
            timing[f"resolve_{op}_s"] = (time.perf_counter() - t0) / reps
            emit(f"plan_resolution_{op}", f"{timing[f'resolve_{op}_s']:.3e}",
                 f"source={source}")
            kops.resolve_impl(op, 1024, device)       # prime the memo
            t0 = time.perf_counter()
            for _ in range(reps):
                kops.resolve_impl(op, 1024, device)
            timing[f"resolve_{op}_memo_s"] = (time.perf_counter() - t0) / reps
            emit(f"plan_resolution_{op}_memo",
                 f"{timing[f'resolve_{op}_memo_s']:.3e}", f"source={source}")
        emit("plan_resolution_cold_load", f"{cold_s:.3e}")
    finally:
        if cache_dir is not None:
            if prev is None:
                os.environ.pop("REPRO_TORCH_PLAN_CACHE", None)
            else:
                os.environ["REPRO_TORCH_PLAN_CACHE"] = prev
        clear()
    return timing


def _check_surface(ops, impls, dev_type: str) -> None:
    """Refuse, before any probe, what the port cannot probe on this device."""
    for op in ops:
        if op not in KERNEL_OPS + SERVING_OPS:
            raise ValueError(f"--ops {op!r} not in {KERNEL_OPS + SERVING_OPS}")
    if dev_type != "cuda" and "cuda" in impls:
        raise ValueError("--kernels cuda needs --device cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default=",".join(DEFAULT_OPS),
                    help=f"comma list of ops to probe, of {KERNEL_OPS + SERVING_OPS}")
    ap.add_argument("--kernels", default=None,
                    help="comma list of impls to probe (default torch,sorted,cuda "
                         "on the card, torch,sorted on the CPU; flush always "
                         "adds fused)")
    ap.add_argument("--k", default=None,
                    help="comma list of counter budgets (default 256,1024,4096; "
                         "quick 64,256,1024)")
    ap.add_argument("--chunks", default=None,
                    help="comma list of chunk/batch sizes (default 512,2048,8192; "
                         "quick 256,1024)")
    ap.add_argument("--p", default=None,
                    help="comma list of reduction axis sizes to probe (default "
                         "1,2,4; quick 1,2; clipped to the card count on CUDA)")
    ap.add_argument("--strategies", default=",".join(STRATEGIES))
    ap.add_argument("--lanes", type=int, default=2,
                    help="engine lanes (tenants) of the reduction, publish and "
                         "pipeline probes")
    ap.add_argument("--n-reduce", type=int, default=1 << 17,
                    help="stream length behind each reduction probe")
    ap.add_argument("--depth", type=int, default=8,
                    help="engine buffer depth recommendation carried into the plan")
    ap.add_argument("--dtype", default="int32")
    ap.add_argument("--repeat", type=int, default=None,
                    help="timed samples per probe cell (default 3; quick 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device to measure: cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="smoke sizes")
    ap.add_argument("--no-reductions", action="store_true",
                    help="skip the reduction probes")
    ap.add_argument("--no-cache", action="store_true", help="don't write the plan cache")
    ap.add_argument("--cache-dir", default=None,
                    help="plan cache directory (default: $REPRO_TORCH_PLAN_CACHE "
                         "or ~/.cache/repro_torch/plans)")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="--check: a planned choice may be at most this fraction "
                         "slower than the freshly best impl (default 0.5; 1.0 "
                         "under --quick)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the tolerance and bitwise gates hold")
    ap.add_argument("--out", default="BENCH_plan_torch.json")
    args = ap.parse_args(argv)

    dev_type = torch.device(args.device).type
    q = args.quick
    args.k = args.k or ("64,256,1024" if q else "256,1024,4096")
    args.chunks = args.chunks or ("256,1024" if q else "512,2048,8192")
    args.kernels = args.kernels or ("torch,sorted,cuda" if dev_type == "cuda"
                                    else "torch,sorted")
    args.p = args.p or ("1,2" if q else "1,2,4")
    args.repeat = args.repeat if args.repeat is not None else (2 if q else 3)
    if q:
        args.n_reduce = min(args.n_reduce, 1 << 15)
    if args.tolerance is None:
        args.tolerance = 1.0 if q else 0.5

    ops = [o.strip() for o in args.ops.split(",")]
    # the kernel-table machinery (sweep, cost model, tolerance and bitwise
    # gates) only understands impl-choice ops; the serving ops have their
    # own sections below
    kernel_ops = [o for o in ops if o not in SERVING_OPS]
    impls = [i.strip() for i in args.kernels.split(",")]
    ks = sorted({int(k) for k in args.k.split(",")})
    cs = sorted({int(c) for c in args.chunks.split(",")})
    ps = sorted({int(p) for p in args.p.split(",")})
    strategies = [s.strip() for s in args.strategies.split(",")]
    _check_surface(ops, impls, dev_type)

    from repro_torch.plan import (CostModel, ExecutionPlan, device_fingerprint,
                                  plan_path, static_impl)

    print("name,value,derived")

    def emit(name, value, derived=""):
        print(f"{name},{value},{derived}", flush=True)

    fp = device_fingerprint(args.device)
    emit("fingerprint", fp)
    sweep = functools.partial(probe.probe_kernels, dtype=args.dtype, repeat=args.repeat,
                              device=args.device)

    # -- probe + model -------------------------------------------------------
    rows = []
    for op in kernel_ops:
        rows += sweep(ops=(op,), impls=_impls_for_op(op, impls), ks=ks, cs=cs,
                      seed=args.seed, emit=emit)
    # queries run at small padded batches, far below the chunk sizes: probe
    # those cells too (every k, so the query grid stays complete), to site
    # the bucket floor and choose the query table at its operating point
    mb_rows = []
    if "query" in kernel_ops:
        mb_rows = sweep(ops=("query",), impls=impls, ks=ks, cs=(16, 64, 256),
                        seed=args.seed + 2)
    model = CostModel(rows + mb_rows)

    chunk = _choose_chunk(model, ks, cs) if "combine" in kernel_ops else 2048
    min_batch = _choose_query_min_batch(mb_rows, chunk)
    op_c = {"query": min_batch}
    kernels = {op: {k: model.choose_impl(op, k, op_c.get(op, chunk)) for k in ks}
               for op in kernel_ops}

    # held-out validation at geometric-midpoint budgets
    held_out = []
    for op in kernel_ops:
        held_out += sweep(ops=(op,), impls=_impls_for_op(op, impls), ks=_midpoints(ks),
                          cs=[chunk], seed=args.seed + 1)
    validation = model.validate(held_out)
    max_err = max((v["rel_err"] for v in validation), default=0.0)
    emit("model_max_rel_err", f"{max_err:.3f}", f"{len(validation)} held-out cells")

    # the runtime probes run the engine the combine table chose at max k:
    # the engine the serving tier and the runtime actually run
    impl_ref = kernels.get("combine", {}).get(
        max(ks), static_impl("combine", max(ks), on_cuda=dev_type == "cuda"))
    runtime_probe = dict(lanes=args.lanes, chunk=chunk, depth=min(args.depth, 4),
                         impl=impl_ref, repeat=args.repeat, seed=args.seed,
                         device=args.device, emit=emit)

    # -- reduction probes ----------------------------------------------------
    reduce_rows = []
    if not args.no_reductions:
        reduce_rows = probe.probe_reductions(ps=ps, strategies=strategies, k=max(ks),
                                             n=args.n_reduce, **runtime_probe)
    reductions, pods = _choose_reductions(reduce_rows)

    # -- publish probes (serving cadence) ------------------------------------
    publish_rows = []
    if "publish" in ops:
        publish_rows = probe.probe_publish(
            ks=(ks if len(ks) <= 2 else (min(ks), max(ks))), **runtime_probe)
    publish_every, ring_depth = _choose_publish(publish_rows)

    # -- pipeline probes (async-ingestion knobs) -----------------------------
    pipeline_rows = []
    if "pipeline" in ops:
        pipeline_rows = probe.probe_pipeline(
            k=max(ks), coalesce=(1, 2, 4) if q else (1, 2, 4, 8),
            feed_depths=(1, 2) if q else (1, 2, 4), **runtime_probe)
    coalesce_max, feed_depth, lazy_publish = _choose_pipeline(pipeline_rows)

    plan = ExecutionPlan(fingerprint=fp, source="measured", kernels=kernels,
                         reductions=reductions, pods=pods, chunk=chunk,
                         buffer_depth=args.depth, query_min_batch=min_batch,
                         publish_every=publish_every, ring_depth=ring_depth,
                         coalesce_max=coalesce_max, feed_depth=feed_depth,
                         lazy_publish=lazy_publish)
    for op in kernel_ops:
        emit(f"plan_{op}", " ".join(f"k{k}:{v}" for k, v in sorted(kernels[op].items())))
    emit("plan_chunk", chunk)
    emit("plan_query_min_batch", min_batch)
    emit("plan_publish_every", publish_every, f"budget={PUBLISH_BUDGET:.0%}")
    emit("plan_ring_depth", ring_depth)
    emit("plan_coalesce_max", coalesce_max, f"slack={PIPELINE_SLACK:.0%}")
    emit("plan_feed_depth", feed_depth)
    emit("plan_lazy_publish", str(lazy_publish).lower(),
         f"min_ratio={LAZY_PUBLISH_MIN_RATIO:.0%}")
    for p, strategy in sorted(reductions.items()):
        emit(f"plan_reduction_p{p}", strategy, f"pods={pods.get(p, 1)}")

    # -- gates ---------------------------------------------------------------
    # (a) tolerance: every impl re-measured at the gate cell in the same
    # pass, in alternating rounds (fresh vs fresh cancels load drift since
    # the sweep, and a stall inflates one round, not one impl); the static
    # impl is always among them, so a pass also bounds the plan against it
    entry = probe.entry_points()
    gate_rows, failures = [], []
    for op in kernel_ops:
        for k in ks:
            planned, c_cell = kernels[op][k], op_c.get(op, chunk)
            cell_args = probe._probe_inputs(op, k, c_cell, args.dtype, args.seed,
                                            args.device)
            static = static_impl(op, k, on_cuda=dev_type == "cuda")
            fresh = probe.timeit_rounds(
                {impl: functools.partial(entry[op], impl=impl)
                 for impl in dict.fromkeys([*_impls_for_op(op, impls), static])},
                *cell_args, repeat=args.repeat)
            row, failure = gate_cell(op, k, c_cell, planned, static, fresh,
                                     args.tolerance)
            gate_rows.append(row)
            if failure:
                failures.append(failure)
            emit(f"gate_{op}_k{k}", f"{row['margin']:.3f}",
                 f"planned={planned};static={static}")

    # (b) bitwise: plan-resolved 'auto' ≡ every impl, per op and end to end
    bitwise = _bitwise_gate(plan, impls, emit, seed=args.seed, ops=kernel_ops,
                            device=args.device)
    failures += [f"bitwise: auto(plan) != {key}" for key, ok in bitwise.items() if not ok]

    # -- publish: only a plan that passed its own gates reaches the cache ----
    cache_file = None
    if failures:
        emit("plan_cache", "skipped", f"{len(failures)} gate failure(s)")
    elif not args.no_cache:
        cache_file = plan.save(plan_path(fp, args.cache_dir))
        emit("plan_cache", str(cache_file), "written")

    timing = resolution_timing(emit, cache_dir=args.cache_dir, device=args.device)
    timing["file"] = str(cache_file or "")

    record = {
        "config": {
            "ops": ops, "impls": impls, "ks": ks, "cs": cs, "ps": ps,
            "strategies": strategies, "lanes": args.lanes, "dtype": args.dtype,
            "repeat": args.repeat, "tolerance": args.tolerance,
            "device": args.device,
            "device_name": (torch.cuda.get_device_name(torch.device(args.device))
                            if dev_type == "cuda" else platform.processor()
                            or platform.machine()),
            "torch": torch.__version__,
        },
        "fingerprint": fp,
        "probes": rows,
        "min_batch_probes": mb_rows,
        "reduction_probes": reduce_rows,
        "publish_probes": publish_rows,
        "pipeline_probes": pipeline_rows,
        "validation": validation,
        "model_max_rel_err": max_err,
        "plan": plan.to_json(),
        "plan_cache": str(cache_file or ""),
        "check": {"tolerance_cells": gate_rows, "bitwise_equivalent": bitwise,
                  "failures": failures},
        "plan_resolution": timing,
    }
    Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    emit("plan_json", args.out, "written")

    if args.check:
        if failures:
            for f in failures:
                print(f"CHECK FAILED: {f}", file=sys.stderr)
            return 1
        print("check,ok,tolerance + bitwise gates hold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
