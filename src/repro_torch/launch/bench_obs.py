"""Observability overhead + health + drift + flight gates (DESIGN.md §12, §14).

The counterpart of ``repro.launch.bench_obs``. Four claims make the obs
layer safe to leave on in production, and this harness turns them into
gates:

  1. **Overhead.** Sustained ingest throughput with the tier's
     metrics/tracer/health stack ON must stay within ``--min-ratio``
     (default 0.97) of the metrics-OFF tier on the same ``bench_serve``
     workload. Both arms reuse ``bench_serve._run_tier`` against ONE
     shared StreamRuntime (the same engine: the arms differ only in
     instrumentation), run ``--reps`` times interleaved (off/on/off/on —
     drift hits both arms equally), and each arm scores its BEST rep.
  2. **Health consistency.** The sketch-native health gauges
     (``obs.health.sketch_health``, refreshed off the ring by the
     HealthMonitor) must agree *bitwise* with the eval harness's
     oracle-free invariants (``eval.accuracy.oracle_free_invariants``)
     computed from a synchronous reference ingest + QueryFrontend report
     at the same stream position.
  3. **Drift accuracy.** The online skew estimator
     (``obs.drift.fit_zipf_skew``) must bracket the *generator's* zipf
     parameter inside its own reported confidence interval at every
     profile s ∈ ``eval.accuracy.SKEWS`` = {1.1, 1.5, 2.0}.
  4. **Flight recording.** An induced IngestLoop failure (a poison block
     that raises during host staging) must produce one complete,
     strict-JSON, schema-valid flight-recorder artifact
     (``obs.recorder.validate_flight_record``) carrying the traceback and
     at least one pre-error postmortem frame.

The overhead arms run with the FULL sentinel on: the metrics-ON tier
carries timeseries sampling, drift estimation, alert evaluation, and
flight-recorder frame capture — the ≥ ``--min-ratio`` gate prices the
whole §14 stack, not just counters.

Results: ``name,value,derived`` CSV on stdout + ``BENCH_obs_torch.json``.

  python -m repro_torch.launch.bench_obs                          # on the card
  python -m repro_torch.launch.bench_obs --device cpu --quick --check
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

# every field oracle_free_invariants emits; all but guaranteed_fraction
# are python ints/bools and must match bitwise
HEALTH_FIELDS = ("n", "k", "occupancy", "min_count", "threshold",
                 "complete", "candidates", "guaranteed", "unconfirmed",
                 "guaranteed_fraction")


def compare_health(health: dict, reference: dict) -> list[str]:
    """Field-by-field exact comparison; one line per mismatch."""
    mismatches = []
    for field in HEALTH_FIELDS:
        got, want = health.get(field), reference[field]
        if got != want:
            mismatches.append(f"{field}: health gauge {got!r} != "
                              f"oracle-free invariant {want!r}")
    return mismatches


def run_drift_phase(rt, *, blocks, block_items, chunk, seed,
                    emit=lambda *a: None) -> list[dict]:
    """Skew-estimator accuracy at every profile of ``SKEWS`` (gate 3).

    For each s: synchronous reference ingest of a fresh zipf(s) stream,
    one snapshot, one ``fit_zipf_skew`` over the sketch's own counters —
    exactly the estimator the tier's DriftEstimator runs off ring
    publishes — plus the 1401.0702 predicted-ε mapping at the estimate vs
    the sketch's actual min-count.
    """
    import numpy as np

    from repro_torch.core.spacesaving import EMPTY
    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.eval.accuracy import SKEWS
    from repro_torch.obs.drift import fit_zipf_skew, predicted_min_count
    from repro_torch.obs.health import sketch_health
    from repro_torch.runtime.feed import host_blocks

    results = []
    for si, s_true in enumerate(SKEWS):
        state = rt.init()
        for i in range(blocks):
            b = zipf_stream(block_items, s_true, seed=seed + 1000 * (si + 1) + i,
                            max_id=10**6)
            state = rt.ingest(state, host_blocks(b, rt.workers, chunk))
        snap = rt.snapshot(state)
        h = sketch_health(snap)
        items, counts, errors = (t.cpu().numpy() for t in snap.summary)
        counts = np.where(items != EMPTY, counts, 0)
        fit = fit_zipf_skew(counts, errors)
        pred = predicted_min_count(h["n"], h["k"], fit["s"])
        within = bool(fit["ci_low"] <= s_true <= fit["ci_high"])
        row = {"s_true": s_true, "s_est": fit["s"],
               "ci_low": fit["ci_low"], "ci_high": fit["ci_high"],
               "stderr": fit["stderr"], "ranks_used": fit["ranks_used"],
               "r2": fit["r2"], "within_ci": within, "n": h["n"],
               "k": h["k"], "predicted_min_count": pred,
               "actual_min_count": h["min_count"],
               "epsilon_vs_predicted": (h["min_count"] / pred
                                        if pred and pred == pred else None)}
        results.append(row)
        emit(f"obs_drift_s{s_true}", f"{fit['s']:.4f}",
             f"ci=[{fit['ci_low']:.4f},{fit['ci_high']:.4f}] "
             f"within={within} ranks={fit['ranks_used']}")
    return results


class _PoisonBlock:
    """A submitted block that raises during host staging — the induced
    IngestLoop failure of the flight gate (never touches the device)."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("bench_obs induced ingest failure")


def run_flight_phase(rt, *, chunk, flight_path, emit=lambda *a: None) -> dict:
    """Induced-error flight-recorder dump (gate 4)."""
    import os
    import time

    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.obs.recorder import validate_flight_record
    from repro_torch.serve import ServeConfig, ServingTier

    if os.path.exists(flight_path):
        os.remove(flight_path)
    cfg = ServeConfig(runtime=rt.config, publish_every=2, ring_depth=2,
                      coalesce_max=1, lazy_publish=False,
                      sample_interval_s=0.05, flight_path=flight_path)
    tier = ServingTier(cfg, runtime=rt)
    result = {"path": flight_path, "valid": False, "reason": None,
              "frames": 0, "error_type": None}
    with tier:
        # healthy traffic first, so the postmortem ring holds real
        # pre-error frames and the dump shows the tier *before* it died
        for i in range(4):
            tier.submit(zipf_stream(rt.workers * chunk, 1.2, seed=90 + i, max_id=10**5))
        tier.drain()
        time.sleep(3 * cfg.sample_interval_s)
        tier.submit(_PoisonBlock())
        deadline = time.perf_counter() + 10.0
        while (time.perf_counter() < deadline
               and tier.recorder.last_dump_path is None):
            time.sleep(0.05)
        try:
            tier.stop(drain=False)
        except RuntimeError:
            pass                    # the induced error, re-raised
    if tier.recorder.last_dump_path is None:
        result["reason"] = "no dump produced within timeout"
        emit("obs_flight_valid", "false", result["reason"])
        return result
    try:
        with open(flight_path) as f:
            record = validate_flight_record(json.load(f))
    except (OSError, ValueError) as e:
        result["reason"] = f"dump invalid: {e}"
        emit("obs_flight_valid", "false", result["reason"])
        return result
    err = record.get("error") or {}
    result.update({
        "valid": bool(record["reason"] == "ingest_error"
                      and err.get("type") == "RuntimeError"
                      and len(record["frames"]) >= 1),
        "reason": record["reason"],
        "frames": len(record["frames"]),
        "error_type": err.get("type"),
    })
    emit("obs_flight_valid", str(result["valid"]).lower(),
         f"reason={result['reason']} frames={result['frames']} "
         f"error={result['error_type']}")
    return result


def run_bench(*, impl="auto", k=2048, lanes=2, chunk=2048, depth=4,
              blocks=128, layers=4, publish_every=None, ring_depth=None,
              queue_depth=8, kmaj=64, reps=3, seed=0, device="cuda",
              flight_path="BENCH_obs_flight_torch.json",
              emit=lambda *a: None) -> dict:
    """The obs record (see the module docstring) for one impl on ``device``.

    The overhead arms' own flight records (``bench_serve._run_tier`` dumps
    one per metrics-on phase) go to a temporary directory; only the
    induced-error artifact is written to ``flight_path``.
    """
    import torch

    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig
    from repro_torch.eval.accuracy import oracle_free_invariants
    from repro_torch.launch.bench_serve import _run_tier
    from repro_torch.plan import device_fingerprint
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    from repro_torch.runtime.feed import host_blocks

    rt = StreamRuntime(RuntimeConfig(
        engine=EngineConfig(k=k, tenants=lanes, chunk=chunk, buffer_depth=depth,
                            kernel=impl, device=str(device)),
        shards=1))
    block_items = rt.workers * chunk * layers
    host_stream = [zipf_stream(block_items, 1.1, seed=seed + i, max_id=10**6)
                   for i in range(blocks)]
    items_total = blocks * block_items

    with tempfile.TemporaryDirectory(prefix="bench-obs-arms-") as tmp:
        tier_kw = dict(publish_every=publish_every, ring_depth=ring_depth,
                       queue_depth=queue_depth, admission="block", kmaj=kmaj,
                       flight_path=str(Path(tmp) / "flight_record.json"))

        # first launches + publish + health paths outside timing
        _run_tier(rt, host_stream[:2], metrics=True, **tier_kw)

        # interleaved reps: clock drift / background noise on a shared box
        # lands on both arms, and best-of per arm filters the rest
        arms = {False: [], True: []}
        last_on = None
        for rep in range(reps):
            for metrics in (False, True):
                r = _run_tier(rt, host_stream, metrics=metrics, **tier_kw)
                arms[metrics].append(items_total / r["elapsed_s"])
                if metrics:
                    last_on = r
                emit(f"obs_rep{rep}_{'on' if metrics else 'off'}_updates_per_s",
                     f"{arms[metrics][-1]:.4e}", f"elapsed={r['elapsed_s']:.3f}s")

    best_off, best_on = max(arms[False]), max(arms[True])
    ratio = best_on / best_off
    emit("obs_best_off_updates_per_s", f"{best_off:.4e}", f"reps={reps}")
    emit("obs_best_on_updates_per_s", f"{best_on:.4e}", f"reps={reps}")
    emit("obs_overhead_ratio", f"{ratio:.4f}", "on/off best-of")

    # health-consistency: synchronous reference at the same position
    state = rt.init()
    for b in host_stream:
        state = rt.ingest(state, host_blocks(b, rt.workers, chunk))
    snap = rt.snapshot(state)
    report = rt.frontend().k_majority_report(snap, kmaj)
    reference = oracle_free_invariants(snap, report)
    health = dict(last_on["health"] or {})
    mismatches = compare_health(health, reference)
    emit("obs_health_consistent", str(not mismatches).lower(),
         f"fields={len(HEALTH_FIELDS)}")

    # async-pipeline observability (DESIGN.md §13): how the plan's pipeline
    # knobs actually behaved under the obs workload
    pipeline = dict(last_on.get("pipeline") or {})
    co = pipeline.get("coalesce_blocks") or {}
    emit("obs_pipeline_coalesce_max", pipeline.get("coalesce_max", 1),
         f"mean_blocks_per_dispatch={co.get('mean', 1.0):.2f}"
         if co.get("count") else "")
    emit("obs_pipeline_publishes_deferred", pipeline.get("publishes_deferred", 0),
         f"materialized={pipeline.get('publishes_materialized', 0)}")
    emit("obs_pipeline_health_deferred", pipeline.get("health_deferred", 0),
         "lazy versions skipped")

    # drift phase (gate 3): ~400k items per profile is where the fit's
    # jackknife CI was calibrated; more adds ingest time, not accuracy
    drift_blocks = max(8, min(blocks, 400_000 // block_items + 1))
    drift = run_drift_phase(rt, blocks=drift_blocks, block_items=block_items,
                            chunk=chunk, seed=seed, emit=emit)

    # flight phase (gate 4): induced ingest error → one valid artifact
    flight = run_flight_phase(rt, chunk=chunk, flight_path=flight_path, emit=emit)

    dev_type = torch.device(device).type
    return {
        "config": {
            "impl": impl, "k": k, "lanes": lanes, "chunk": chunk,
            "buffer_depth": depth, "blocks": blocks, "layers": layers,
            "publish_every": publish_every, "ring_depth": ring_depth,
            "queue_depth": queue_depth, "k_majority": kmaj, "reps": reps,
            "seed": seed, "backend": dev_type,
            "devices": torch.cuda.device_count() if dev_type == "cuda" else 1,
        },
        "fingerprint": device_fingerprint(device),
        "overhead": {
            "off_updates_per_s": arms[False],
            "on_updates_per_s": arms[True],
            "best_off": best_off,
            "best_on": best_on,
            "ratio": ratio,
        },
        "health": {
            "tier": health,
            "reference": reference,
            "mismatches": mismatches,
        },
        "pipeline": pipeline,
        "drift": drift,
        "flight": flight,
        "metrics_on_stats": last_on["stats"],
    }


def check_record(record: dict, *, min_ratio: float) -> list[str]:
    """The obs gates — every violation is one line. Empty list = pass."""
    failures = []
    ratio = record["overhead"]["ratio"]
    if not (ratio >= min_ratio):
        failures.append(
            f"metrics-on ingest at {ratio:.4f}x of metrics-off "
            f"(overhead SLO >= {min_ratio})")
    for m in record["health"]["mismatches"]:
        failures.append(f"health inconsistency — {m}")
    if not record["health"]["tier"]:
        failures.append("metrics-on tier published no health — the "
                        "monitor measured nothing")
    drift = record.get("drift") or []
    if not drift:
        failures.append("drift phase produced no profiles")
    for row in drift:
        if not row["within_ci"]:
            failures.append(
                f"drift estimator missed s={row['s_true']}: estimated "
                f"{row['s_est']:.4f}, CI [{row['ci_low']:.4f}, "
                f"{row['ci_high']:.4f}] does not cover truth")
    flight = record.get("flight") or {}
    if not flight.get("valid"):
        failures.append(
            f"flight-recorder gate failed — "
            f"{flight.get('reason', 'phase did not run')}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the tier runs: cuda (default) or cpu")
    ap.add_argument("--kernel", default=None,
                    help="engine impl (default auto on the card, torch on the CPU)")
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--publish-every", type=int, default=None)
    ap.add_argument("--ring-depth", type=int, default=None)
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--k-majority", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3,
                    help="repetitions per arm (best-of scores)")
    ap.add_argument("--min-ratio", type=float, default=0.97,
                    help="--check: metrics-on/off throughput floor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="smoke sizes (k=256, chunk=512, fewer blocks)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless overhead + health + drift + "
                         "flight gates hold")
    ap.add_argument("--out", default="BENCH_obs_torch.json")
    ap.add_argument("--flight-out", default="BENCH_obs_flight_torch.json",
                    help="induced-error flight-recorder artifact path")
    args = ap.parse_args(argv)

    if args.quick:
        # long enough per rep that the ratio measures steady-state
        # ingest, not thread startup
        args.k, args.chunk, args.depth = 256, 512, 2
        args.blocks, args.layers = 160, 8
        args.reps = min(args.reps, 3)
    kernel = args.kernel or ("auto" if args.device == "cuda" else "torch")

    from repro_torch.plan import active_plan
    plan = active_plan(args.device)
    publish_every = args.publish_every or plan.publish_every
    ring_depth = args.ring_depth or plan.ring_depth

    print("name,value,derived")

    def emit(name, value, derived=""):
        print(f"{name},{value},{derived}", flush=True)

    record = run_bench(
        impl=kernel, k=args.k, lanes=args.lanes, chunk=args.chunk,
        depth=args.depth, blocks=args.blocks, layers=args.layers,
        publish_every=publish_every, ring_depth=ring_depth,
        queue_depth=args.queue_depth, kmaj=args.k_majority,
        reps=args.reps, seed=args.seed, device=args.device,
        flight_path=args.flight_out, emit=emit)

    Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    emit("obs_json", args.out, "written")

    if args.check:
        failures = check_record(record, min_ratio=args.min_ratio)
        if failures:
            for f in failures:
                print(f"CHECK FAILED: {f}", file=sys.stderr)
            return 1
        print("check,ok,overhead + health + drift + flight gates hold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
