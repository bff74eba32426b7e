"""Mixed read/write load harness for the concurrent serving tier.

The counterpart of ``repro.launch.bench_serve``. Measures the claim in
DESIGN.md §11 — *reads never block ingestion* — by running, per kernel
impl, these phases against ONE StreamRuntime (so every phase runs the same
engine):

  1. **reference**: the same host blocks ingested synchronously through
     ``StreamRuntime.ingest`` — the bitwise ground truth for the served
     sketch. With ``reference_impl`` (``--reference``) a second runtime of
     that impl ingests the same blocks, and every impl's reference must
     equal it too.
  2. **warmup**: a throwaway ServingTier ingests two blocks and runs each
     query op once (the first launch of a kernel builds it; torch compiles
     nothing per shape, so no coalesced shapes need warming).
  3. **baseline**: a fresh tier ingests the full stream with zero
     readers — the reader-free sustained updates/sec.
  4. **loaded**: a fresh tier ingests the identical stream while reader
     threads fire point / top-n / k-majority queries at a throttled
     aggregate ``--qps`` against the ring. Per-op wall-clock latency
     (which *includes* waiting for the snapshot's device work — the
     reader pays the freshness cost, by design) comes from the tier's OWN
     ``serve.read.{op}_s`` histograms, with their ``bucket_error_bound``.

After the drain of each phase the tier's health gauges are held against
``eval.accuracy.oracle_free_invariants`` of the drained snapshot, and a
flight record is dumped (into a temporary directory unless ``flight_dir``
is given) and validated.

A fifth, reader-free **pipeline** phase (DESIGN.md §13) runs a shortened
stream through the legacy serving discipline (one block per dispatch, no
staging overlap, eager publishes) and through the tuned pipeline
(plan-resolved ``coalesce_max`` / ``feed_depth`` / ``lazy_publish``) and
records the throughput ``gain`` per impl. ``--budget-s`` caps each phase's
stream from a measured per-block cost so the whole run fits a time budget
without touching any gate.

Each phase also records the publishes, the lazy publishes readers forced
(``serve.publish.materialized``), and the device→host copies the sentinel
threads made (``obs.health.HOST_COPIES``, health and drift refreshes).

``--check`` gates, as the JAX package's:

  * ingest-with-readers within ``--min-ingest-ratio`` (default 0.9) of
    the same run's reader-free baseline — the ≤10% interference SLO;
  * per-op p50/p99 latency under ``--p50-slo``/``--p99-slo``;
  * baseline AND loaded drained snapshots bitwise-identical to the
    synchronous reference (and to ``--reference``'s); lazy publishes
    bitwise-identical to eager ones; the pipeline arms bitwise-identical
    to each other; the health gauges equal to the oracle-free invariants;
    a flight record that validates;
  * admission accounting closes: submitted + shed == offered, and every
    admitted block was ingested by drain time;
  * no perf regression: loaded updates/sec at least
    ``--min-regression-frac`` (default 0.9) of the committed ``--out``
    record's, compared only when the device fingerprint AND workload
    shape match (warn-skip otherwise).

Results: ``name,value,derived`` CSV on stdout + ``BENCH_serve_torch.json``
(the repo root's ``BENCH_serve.json`` is the JAX package's record).

  python -m repro_torch.launch.bench_serve --check            # on the card
  python -m repro_torch.launch.bench_serve --device cpu --quick --check \\
      --kernels sorted,torch
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import threading
import time
from pathlib import Path

QUERY_OPS = ("point", "top", "kmaj")


def _snapshot_digest(snap):
    """Host copies of the summary leaves + n (phase-comparable identity)."""
    return ([leaf.cpu().numpy() for leaf in snap.summary], int(snap.n))


def _digests_equal(a, b) -> bool:
    (leaves_a, n_a), (leaves_b, n_b) = a, b
    return n_a == n_b and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(leaves_a, leaves_b))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reader(frontend, stop, *, queries, kmaj, period, offset):
    """One reader thread: round-robin op mix, throttled to ``1/period`` qps.

    The reader does NOT time its own calls: the instrumented ServeFrontend
    records wall-clock latency — ring lookup + batched query dispatch +
    host materialization of the answer — into the tier's
    ``serve.read.{op}_s`` histograms.
    """
    i = offset
    nxt = time.perf_counter()
    while not stop.is_set():
        op = QUERY_OPS[i % len(QUERY_OPS)]
        i += 1
        if op == "point":
            frontend.estimate(queries)
        elif op == "top":
            frontend.top_table(10)
        else:
            frontend.k_majority_report(kmaj)
        if period:
            nxt += period
            delay = nxt - time.perf_counter()
            if delay > 0:
                stop.wait(delay)
            else:           # fell behind: resynchronize, don't burst
                nxt = time.perf_counter()


def _run_tier(runtime, blocks, *, publish_every, ring_depth, queue_depth,
              admission, flight_path, readers=0, qps=0.0, queries=None,
              kmaj=64, warm_queries=False, metrics=True, coalesce_max=None,
              feed_depth=None, lazy_publish=None):
    """One tier phase: submit every block, drain, return measurements.

    With ``metrics`` on, the tier's health gauges are held against the
    oracle-free invariants of the drained snapshot, and a flight record is
    dumped and validated (``audit``). The pipeline knobs default to
    ``None`` → the active plan's resolution; explicit values pin one arm
    of the legacy-vs-pipeline comparison.
    """
    import dataclasses

    from repro_torch.eval.accuracy import oracle_free_invariants
    from repro_torch.obs import health as obs_health
    from repro_torch.obs.recorder import validate_flight_record
    from repro_torch.serve import ServeConfig, ServingTier

    rcfg = runtime.config
    if feed_depth is not None:
        rcfg = dataclasses.replace(rcfg, feed_depth=feed_depth)
    cfg = ServeConfig(runtime=rcfg, publish_every=publish_every,
                      ring_depth=ring_depth, coalesce_max=coalesce_max,
                      lazy_publish=lazy_publish, queue_depth=queue_depth,
                      admission=admission, metrics=metrics,
                      health_k_majority=kmaj, flight_path=flight_path)
    device = runtime.engine.device
    copies0 = obs_health.HOST_COPIES
    tier = ServingTier(cfg, runtime=runtime).start()
    audit_out = None
    try:
        if warm_queries:
            tier.frontend.estimate(queries)
            tier.frontend.top_table(10)
            tier.frontend.k_majority_report(kmaj)

        stop = threading.Event()
        threads = []
        period = readers / qps if (readers and qps) else 0.0
        for r in range(readers):
            t = threading.Thread(
                target=_reader, args=(tier.frontend, stop),
                kwargs=dict(queries=queries, kmaj=kmaj, period=period,
                            offset=r), daemon=True)
            threads.append(t)
            t.start()

        _sync(device)
        t0 = time.perf_counter()
        for b in blocks:
            tier.submit(b)
        snap = tier.drain()
        # barrier: the phase ends when ingest COMPUTE is done, not when
        # its dispatches were enqueued (lazy publishes never force one)
        tier.loop.sync()
        elapsed = time.perf_counter() - t0

        stop.set()
        for t in threads:
            t.join()
        sentinel_copies = obs_health.HOST_COPIES - copies0
        stats = tier.stats.describe()
        query_stats = {}
        for op in QUERY_OPS:
            d = tier.registry.histogram(f"serve.read.{op}_s").describe()
            query_stats[op] = {
                "count": d["count"],
                "p50_s": d.get("p50", float("nan")),
                "p99_s": d.get("p99", float("nan")),
                "mean_s": d.get("mean", float("nan")),
                "bucket_error_bound": d.get("error_bound", 0.0),
            }
        health = tier.health_report() if metrics else None
        if metrics:
            report = runtime.frontend().k_majority_report(snap, kmaj)
            want = oracle_free_invariants(snap, report)
            got = health if health is not None else {}
            mismatched = sorted(key for key, v in want.items()
                                if got.get(key) != v)
            record_path = tier.dump_flight_record(reason="bench_serve")
            try:
                validate_flight_record(json.loads(Path(record_path).read_text()))
                flight_ok, flight_error = True, None
            except (ValueError, OSError) as e:
                flight_ok, flight_error = False, str(e)
            audit_out = {"health_consistent": not mismatched,
                         "health_mismatched": mismatched,
                         "flight_record_valid": flight_ok,
                         "flight_record_error": flight_error}
        pipeline = {
            "coalesce_max": tier.coalesce_max,
            "feed_depth": tier.feed_depth,
            "lazy_publish": tier.lazy_publish,
        }
        if metrics:
            reg = tier.registry
            pipeline.update({
                "coalesce_blocks": reg.histogram(
                    "serve.ingest.coalesce_blocks").describe(),
                "publishes_deferred": reg.counter(
                    "serve.publish.deferred").value,
                "publishes_materialized": reg.counter(
                    "serve.publish.materialized").value,
                "health_deferred": reg.counter(
                    "obs.health.deferred").value,
                "floor_answers": reg.counter(
                    "serve.read.floor_answers").value,
                "sentinel_host_copies": sentinel_copies,
                # host seconds of the loop thread: its ingest steps
                # (staging + dispatch) and its publishes
                "step_s": reg.histogram("serve.ingest.step_s").describe(),
                "publish_s": reg.histogram("serve.ingest.publish_s").describe(),
            })
    finally:
        tier.stop(drain=False)

    return {"elapsed_s": elapsed, "snapshot": snap,
            "digest": _snapshot_digest(snap), "stats": stats,
            "queries": query_stats, "health": health, "pipeline": pipeline,
            "audit": audit_out}


def run_bench(*, impls, k, lanes, chunk, depth, blocks, layers,
              publish_every, ring_depth, queue_depth, admission, readers,
              qps, kmaj, coalesce_max=1, feed_depth=2, lazy_publish=False,
              budget_s=None, pipeline_blocks=96,
              pipeline_coalesce_max=None, pipeline_feed_depth=None,
              pipeline_lazy=None, seed=0, device="cuda", host_stream=None,
              reference_impl=None, flight_dir=None, keep=None,
              emit=lambda *a: None) -> dict:
    """The bench record (see module docstring).

    ``host_stream`` hands in the host blocks (a list of (N,) numpy arrays,
    ``blocks`` of them are used) instead of zipf(1.1) blocks of
    ``lanes × chunk × layers`` ids made from ``seed``. ``keep(impl, phase,
    snapshot)`` receives each phase's drained snapshot (``reference``,
    ``baseline``, ``loaded``, ``legacy``, ``tuned``).
    """
    import numpy as np
    import torch

    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig
    from repro_torch.plan import device_fingerprint
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    from repro_torch.runtime.feed import host_blocks

    keep = keep or (lambda *a: None)
    tmp = None
    if flight_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="bench-serve-flight-")
        flight_dir = tmp.name

    def runtime(impl):
        return StreamRuntime(RuntimeConfig(
            engine=EngineConfig(k=k, tenants=lanes, chunk=chunk,
                                buffer_depth=depth, kernel=impl, device=device),
            shards=1))

    def sync_ingest(rt, stream):
        state = rt.init()
        for b in stream:
            state = rt.ingest(state, host_blocks(b, rt.workers, chunk))
        return state

    results = {}
    ref_digest = None
    try:
        for impl in impls:
            rt = runtime(impl)
            if host_stream is not None:
                stream_all = list(host_stream[:blocks])
            else:
                stream_all = [zipf_stream(rt.workers * chunk * layers, 1.1,
                                          seed=seed + i, max_id=10**6)
                              for i in range(blocks)]
            block_items = int(stream_all[0].size)
            queries = np.random.default_rng(seed).integers(
                0, 10**6, size=8).astype(np.int32)
            flight_path = str(Path(flight_dir) / f"flight_record_{impl}.json")

            # 0. duration budget: cap each phase's stream so one impl's
            # timed work fits ~budget_s, from a measured per-block cost of
            # sync ingest (floor 32 blocks — fewer would starve the
            # percentile/ratio gates of samples)
            blocks_used = len(stream_all)
            if budget_s:
                st = rt.ingest(rt.init(),
                               host_blocks(stream_all[0], rt.workers, chunk))
                _sync(device)
                t0 = time.perf_counter()
                st = rt.ingest(st, host_blocks(stream_all[1], rt.workers, chunk))
                _sync(device)
                per_block = max(time.perf_counter() - t0, 1e-9)
                blocks_used = max(32, min(blocks_used,
                                          int(budget_s / per_block / 3)))
                if blocks_used < len(stream_all):
                    emit(f"serve_{impl}_budget_blocks", blocks_used,
                         f"block_s={per_block:.3e};budget_s={budget_s}")
            stream = stream_all[:blocks_used]
            items_total = sum(int(b.size) for b in stream)

            # 1. reference: the synchronous ground truth over the SAME
            # per-block canonical decomposition the IngestLoop applies
            state = sync_ingest(rt, stream)
            ref_snap = rt.snapshot(state)
            reference = _snapshot_digest(ref_snap)
            keep(impl, "reference", ref_snap)
            if reference_impl is not None and ref_digest is None:
                ref_digest = _snapshot_digest(
                    runtime(reference_impl).snapshot(
                        sync_ingest(runtime(reference_impl), stream)))
            ref_ok = ref_digest is None or _digests_equal(reference, ref_digest)
            if reference_impl is not None:
                emit(f"serve_{impl}_reference_equiv", str(ref_ok).lower(),
                     f"reference={reference_impl}")

            # 1b. lazy ≡ eager on the reference state: same position, same
            # reduction — the deferred publish changes WHEN the merge runs,
            # never what it computes
            lazy_snap = rt.snapshot(state, lazy=True,
                                    n_hint=int(state.n.sum()))
            lazy_ok = _digests_equal(_snapshot_digest(lazy_snap), reference)
            emit(f"serve_{impl}_lazy_eager_equiv", str(lazy_ok).lower(),
                 f"version={lazy_snap.version}")
            del state, lazy_snap

            common = dict(publish_every=publish_every, ring_depth=ring_depth,
                          queue_depth=queue_depth, admission=admission,
                          flight_path=flight_path, queries=queries, kmaj=kmaj)
            # 2. warmup tier: first launches + publish + query paths
            _run_tier(rt, stream[:2], warm_queries=True,
                      coalesce_max=coalesce_max, feed_depth=feed_depth,
                      lazy_publish=lazy_publish, **common)
            pipe_c = (coalesce_max if pipeline_coalesce_max is None
                      else pipeline_coalesce_max)
            pipe_f = (feed_depth if pipeline_feed_depth is None
                      else pipeline_feed_depth)
            pipe_l = lazy_publish if pipeline_lazy is None else pipeline_lazy

            # 3. reader-free baseline
            base = _run_tier(rt, stream, coalesce_max=coalesce_max,
                             feed_depth=feed_depth, lazy_publish=lazy_publish,
                             **common)
            keep(impl, "baseline", base["snapshot"])
            base_ups = items_total / base["elapsed_s"]
            base_ok = _digests_equal(base["digest"], reference)
            emit(f"serve_{impl}_baseline_updates_per_s", f"{base_ups:.4e}",
                 f"elapsed={base['elapsed_s']:.3f}s")

            # 4. identical stream under reader load
            load = _run_tier(rt, stream, readers=readers, qps=qps,
                             coalesce_max=coalesce_max, feed_depth=feed_depth,
                             lazy_publish=lazy_publish, **common)
            keep(impl, "loaded", load["snapshot"])
            load_ups = items_total / load["elapsed_s"]
            load_ok = _digests_equal(load["digest"], reference)
            ratio = load_ups / base_ups
            query_stats = load["queries"]
            reads = sum(q["count"] for q in query_stats.values())
            achieved_qps = reads / load["elapsed_s"]
            emit(f"serve_{impl}_loaded_updates_per_s", f"{load_ups:.4e}",
                 f"readers={readers};qps={achieved_qps:.1f}")
            emit(f"serve_{impl}_ingest_ratio", f"{ratio:.3f}",
                 "loaded/baseline updates_per_s")
            emit(f"serve_{impl}_equivalent",
                 str(base_ok and load_ok).lower(),
                 f"baseline={base_ok};loaded={load_ok}")
            for op, q in query_stats.items():
                emit(f"serve_{impl}_{op}_p50", f"{q['p50_s']:.4e}",
                     f"n={q['count']};bucketized±{q['bucket_error_bound']:.0%}")
                emit(f"serve_{impl}_{op}_p99", f"{q['p99_s']:.4e}",
                     f"n={q['count']}")
            audits = {"baseline": base["audit"], "loaded": load["audit"]}
            emit(f"serve_{impl}_health_consistent",
                 str(all(a["health_consistent"] for a in audits.values())).lower(),
                 ",".join(f"{ph}:{key}" for ph, a in audits.items()
                          for key in a["health_mismatched"]))
            emit(f"serve_{impl}_flight_record_valid",
                 str(all(a["flight_record_valid"] for a in audits.values())).lower(),
                 ";".join(a["flight_record_error"] for a in audits.values()
                          if a["flight_record_error"]))

            # 5. pipeline gain: the SAME shortened reader-free stream
            # through the legacy serving discipline (one block per
            # dispatch, no staging overlap, eager publishes) vs the tuned
            # pipeline arm
            pstream = stream[:min(blocks_used, pipeline_blocks)]
            pitems = sum(int(b.size) for b in pstream)
            legacy = _run_tier(rt, pstream, coalesce_max=1, feed_depth=1,
                               lazy_publish=False, **common)
            tuned = _run_tier(rt, pstream, coalesce_max=pipe_c,
                              feed_depth=pipe_f, lazy_publish=pipe_l, **common)
            keep(impl, "legacy", legacy["snapshot"])
            keep(impl, "tuned", tuned["snapshot"])
            legacy_ups = pitems / legacy["elapsed_s"]
            tuned_ups = pitems / tuned["elapsed_s"]
            gain = tuned_ups / legacy_ups
            pipe_ok = _digests_equal(legacy["digest"], tuned["digest"])
            emit(f"serve_{impl}_pipeline_gain", f"{gain:.3f}",
                 f"legacy={legacy_ups:.3e};tuned={tuned_ups:.3e};"
                 f"coalesce={pipe_c};feed={pipe_f};lazy={pipe_l}")

            results[impl] = {
                "block_items": block_items,
                "blocks_used": blocks_used,
                "items_total": items_total,
                "lazy_eager_equivalent": lazy_ok,
                "reference_equivalent": ref_ok,
                "baseline": {"elapsed_s": base["elapsed_s"],
                             "updates_per_s": base_ups,
                             "equivalent": base_ok,
                             "stats": base["stats"],
                             "audit": base["audit"],
                             "pipeline": base["pipeline"]},
                "loaded": {"elapsed_s": load["elapsed_s"],
                           "updates_per_s": load_ups,
                           "equivalent": load_ok,
                           "reads_total": reads,
                           "achieved_qps": achieved_qps,
                           "queries": query_stats,
                           "stats": load["stats"],
                           "health": load["health"],
                           "audit": load["audit"],
                           "pipeline": load["pipeline"]},
                "ingest_ratio": ratio,
                "pipeline": {
                    "blocks": len(pstream),
                    "legacy_updates_per_s": legacy_ups,
                    "tuned_updates_per_s": tuned_ups,
                    "gain": gain,
                    "equivalent": pipe_ok,
                    "legacy": legacy["pipeline"],
                    "tuned": tuned["pipeline"],
                },
            }
    finally:
        if tmp is not None:
            tmp.cleanup()

    ratios = [r["ingest_ratio"] for r in results.values()]
    p99s = [q["p99_s"] for r in results.values()
            for q in r["loaded"]["queries"].values()
            if math.isfinite(q["p99_s"])]
    gains = {i: r["pipeline"]["gain"] for i, r in results.items()}
    dev_type = torch.device(device).type
    return {
        "config": {
            "impls": list(impls), "k": k, "lanes": lanes, "chunk": chunk,
            "buffer_depth": depth, "blocks": blocks, "layers": layers,
            "publish_every": publish_every, "ring_depth": ring_depth,
            "queue_depth": queue_depth, "admission": admission,
            "readers": readers, "qps": qps, "k_majority": kmaj,
            "coalesce_max": coalesce_max, "feed_depth": feed_depth,
            "lazy_publish": lazy_publish, "budget_s": budget_s,
            "pipeline_blocks": pipeline_blocks,
            "reference_impl": reference_impl,
            "backend": dev_type,
            "devices": torch.cuda.device_count() if dev_type == "cuda" else 1,
        },
        "fingerprint": device_fingerprint(device),
        "impls": results,
        "summary": {
            "min_ingest_ratio": min(ratios) if ratios else float("nan"),
            "worst_p99_s": max(p99s) if p99s else float("nan"),
            "all_equivalent": all(
                r["baseline"]["equivalent"] and r["loaded"]["equivalent"]
                and r["reference_equivalent"] for r in results.values()),
            "all_lazy_eager_equivalent": all(
                r["lazy_eager_equivalent"] for r in results.values()),
            "pipeline_gains": gains,
            "best_pipeline_gain": max(gains.values()) if gains
            else float("nan"),
        },
    }


def check_record(record: dict, *, min_ratio: float, p50_slo: float,
                 p99_slo: float) -> list[str]:
    """The serve SLO gate — every violation is one line."""
    failures = []
    for impl, r in record["impls"].items():
        blocks = r.get("blocks_used", record["config"]["blocks"])
        if not r["baseline"]["equivalent"]:
            failures.append(f"{impl}: baseline tier snapshot != "
                            "synchronous reference")
        if not r["loaded"]["equivalent"]:
            failures.append(f"{impl}: loaded tier snapshot != "
                            "synchronous reference")
        if not r.get("reference_equivalent", True):
            failures.append(f"{impl}: synchronous reference != the "
                            f"{record['config'].get('reference_impl')} "
                            "reference")
        if not r.get("lazy_eager_equivalent", True):
            failures.append(f"{impl}: lazy snapshot != eager snapshot "
                            "at the same stream position")
        pipe = r.get("pipeline")
        if pipe is not None and not pipe["equivalent"]:
            failures.append(f"{impl}: pipeline-tuned tier snapshot != "
                            "legacy-discipline tier snapshot")
        for phase in ("baseline", "loaded"):
            audit = r[phase].get("audit") or {}
            if not audit.get("health_consistent", True):
                failures.append(f"{impl}/{phase}: health gauges != oracle-free "
                                f"invariants ({audit.get('health_mismatched')})")
            if not audit.get("flight_record_valid", True):
                failures.append(f"{impl}/{phase}: flight record invalid "
                                f"({audit.get('flight_record_error')})")
        if not (r["ingest_ratio"] >= min_ratio):
            failures.append(
                f"{impl}: ingest under readers at "
                f"{r['ingest_ratio']:.3f}× of reader-free baseline "
                f"(SLO >= {min_ratio})")
        for op, q in r["loaded"]["queries"].items():
            if q["count"] == 0:
                failures.append(f"{impl}/{op}: no reads sampled — the "
                                "loaded phase measured nothing")
                continue
            if not (q["p50_s"] <= p50_slo):
                failures.append(f"{impl}/{op}: p50 {q['p50_s']:.4f}s "
                                f"exceeds SLO {p50_slo}s")
            if not (q["p99_s"] <= p99_slo):
                failures.append(f"{impl}/{op}: p99 {q['p99_s']:.4f}s "
                                f"exceeds SLO {p99_slo}s")
        for phase in ("baseline", "loaded"):
            st = r[phase]["stats"]
            if st["blocks_submitted"] + st["blocks_shed"] != blocks:
                failures.append(
                    f"{impl}/{phase}: admission accounting open — "
                    f"{st['blocks_submitted']} submitted + "
                    f"{st['blocks_shed']} shed != {blocks} offered")
            if st["blocks_ingested"] != st["blocks_submitted"]:
                failures.append(
                    f"{impl}/{phase}: {st['blocks_submitted']} admitted "
                    f"but only {st['blocks_ingested']} ingested by drain")
    return failures


def check_regression(record: dict, committed: dict | None, *,
                     min_frac: float = 0.9,
                     emit=lambda *a: None) -> list[str]:
    """Perf-regression gate vs the committed ``--out`` record.

    Compares sustained under-reader updates/sec per impl against the
    previously committed record FOR THE SAME DEVICE FINGERPRINT AND
    WORKLOAD — unknown/mismatched fingerprints and changed workload configs
    warn-skip (emitted, never failed). A fresh run below ``min_frac`` of
    the committed same-host same-shape number fails.
    """
    if not committed:
        emit("serve_regression_gate", "skipped", "no committed record")
        return []
    old_fp = committed.get("fingerprint")
    new_fp = record.get("fingerprint")
    if not old_fp or old_fp != new_fp:
        emit("serve_regression_gate", "skipped",
             f"fingerprint mismatch (committed={old_fp or 'none'})")
        return []
    # updates/sec only compares across identical workload shapes — blocks
    # is left out deliberately (rates amortize stream length, and
    # --budget-s caps it per host without invalidating the gate)
    shape_keys = ("k", "lanes", "chunk", "buffer_depth", "layers",
                  "publish_every", "ring_depth", "queue_depth",
                  "admission", "readers", "qps", "k_majority")
    old_cfg = committed.get("config", {})
    new_cfg = record.get("config", {})
    drift = [key for key in shape_keys
             if old_cfg.get(key) != new_cfg.get(key)]
    if drift:
        emit("serve_regression_gate", "skipped",
             f"workload config drift ({','.join(drift)})")
        return []
    failures = []
    for impl, r in record["impls"].items():
        old = committed.get("impls", {}).get(impl)
        if not old:
            emit(f"serve_{impl}_regression", "skipped",
                 "impl not in committed record")
            continue
        old_ups = old["loaded"]["updates_per_s"]
        new_ups = r["loaded"]["updates_per_s"]
        frac = new_ups / old_ups if old_ups else float("inf")
        emit(f"serve_{impl}_regression", f"{frac:.3f}",
             f"committed={old_ups:.3e};fresh={new_ups:.3e}")
        if frac < min_frac:
            failures.append(
                f"{impl}: loaded updates/sec regressed to {frac:.3f}× of "
                f"the committed same-fingerprint record "
                f"({new_ups:.3e} vs {old_ups:.3e}; floor {min_frac}×)")
    return failures


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the tier runs: cuda (default) or cpu")
    ap.add_argument("--kernels", default=None,
                    help="comma list of impls of torch,sorted,cuda,fused,auto "
                         "(default: auto,cuda on the card, torch,sorted on "
                         "the CPU)")
    ap.add_argument("--reference", default=None,
                    help="an impl whose synchronous ingest every impl's "
                         "reference must equal bit for bit (e.g. sorted)")
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=4,
                    help="engine buffer depth T")
    ap.add_argument("--blocks", type=int, default=256,
                    help="host stream blocks submitted per phase")
    ap.add_argument("--layers", type=int, default=4,
                    help="chunk layers per block (block = W×chunk×layers)")
    ap.add_argument("--publish-every", type=int, default=None,
                    help="blocks per ring publish (default: active plan)")
    ap.add_argument("--ring-depth", type=int, default=None,
                    help="snapshot ring depth (default: active plan)")
    ap.add_argument("--coalesce-max", type=int, default=None,
                    help="max queued blocks per coalesced ingest dispatch "
                         "(default: active plan)")
    ap.add_argument("--feed-depth", type=int, default=None,
                    help="host→device staging depth (default: active plan)")
    ap.add_argument("--lazy-publish", default="auto",
                    choices=("auto", "on", "off"),
                    help="defer snapshot reductions to the first reader "
                         "(auto: active plan)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="approximate per-impl timed-phase budget in "
                         "seconds; caps --blocks from a measured per-block "
                         "cost (floor 32 blocks, gates unchanged)")
    ap.add_argument("--pipeline-blocks", type=int, default=96,
                    help="stream length of the legacy-vs-pipeline gain "
                         "arms (reader-free, same-run)")
    ap.add_argument("--pipeline-coalesce-max", type=int, default=None,
                    help="coalesce_max of the pipeline A/B's tuned arm "
                         "only (default: the serving phases' value)")
    ap.add_argument("--pipeline-feed-depth", type=int, default=None,
                    help="feed_depth of the pipeline A/B's tuned arm "
                         "only (default: the serving phases' value)")
    ap.add_argument("--pipeline-lazy-publish", default="auto",
                    choices=("auto", "on", "off"),
                    help="lazy_publish of the pipeline A/B's tuned arm "
                         "only (auto: the serving phases' value)")
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--admission", default="block",
                    choices=("block", "shed"))
    ap.add_argument("--readers", type=int, default=4,
                    help="concurrent reader threads in the loaded phase")
    ap.add_argument("--qps", type=float, default=50.0,
                    help="aggregate reader queries/sec (0 = unthrottled)")
    ap.add_argument("--k-majority", type=int, default=64)
    ap.add_argument("--min-ingest-ratio", type=float, default=0.9,
                    help="--check: loaded/baseline updates_per_s floor "
                         "(the <=10%% interference SLO)")
    ap.add_argument("--min-regression-frac", type=float, default=0.9,
                    help="--check: fresh loaded updates_per_s must be at "
                         "least this fraction of the committed --out "
                         "record's (same fingerprint only; else skipped)")
    ap.add_argument("--p50-slo", type=float, default=0.5,
                    help="--check: per-op p50 latency ceiling (s)")
    ap.add_argument("--p99-slo", type=float, default=5.0,
                    help="--check: per-op p99 latency ceiling (s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="smoke sizes (k=256, chunk=512, fewer blocks)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless SLO + bitwise gates hold")
    ap.add_argument("--out", default="BENCH_serve_torch.json")
    args = ap.parse_args(argv)

    if args.quick:
        args.k, args.chunk, args.depth = 256, 512, 2
        args.blocks, args.layers = 120, 8
        args.readers = min(args.readers, 2)
        args.qps = min(args.qps, 25.0)
        args.pipeline_blocks = min(args.pipeline_blocks, 48)
    kernels = args.kernels or ("auto,cuda" if args.device == "cuda"
                               else "torch,sorted")

    # the plan-resolved defaults are materialized HERE (not inside the
    # tier) so the record shows the cadence/pipeline the run actually used
    from repro_torch.plan import active_plan
    plan = active_plan(args.device)
    publish_every = args.publish_every or plan.publish_every
    ring_depth = args.ring_depth or plan.ring_depth
    coalesce_max = args.coalesce_max or plan.coalesce_max
    feed_depth = args.feed_depth or plan.feed_depth
    lazy_publish = (plan.lazy_publish if args.lazy_publish == "auto"
                    else args.lazy_publish == "on")

    print("name,value,derived")

    def emit(name, value, derived=""):
        print(f"{name},{value},{derived}", flush=True)

    emit("serve_publish_every", publish_every, f"plan={plan.source}")
    emit("serve_ring_depth", ring_depth, f"plan={plan.source}")
    emit("serve_coalesce_max", coalesce_max, f"plan={plan.source}")
    emit("serve_feed_depth", feed_depth, f"plan={plan.source}")
    emit("serve_lazy_publish", str(lazy_publish).lower(),
         f"plan={plan.source}")

    # the committed record is read BEFORE run_bench overwrites args.out —
    # it is the regression gate's baseline
    committed = None
    out_path = Path(args.out)
    if out_path.exists():
        try:
            committed = json.loads(out_path.read_text())
        except (OSError, json.JSONDecodeError):
            committed = None

    record = run_bench(
        impls=[i.strip() for i in kernels.split(",")],
        k=args.k, lanes=args.lanes, chunk=args.chunk, depth=args.depth,
        blocks=args.blocks, layers=args.layers,
        publish_every=publish_every, ring_depth=ring_depth,
        queue_depth=args.queue_depth, admission=args.admission,
        readers=args.readers, qps=args.qps, kmaj=args.k_majority,
        coalesce_max=coalesce_max, feed_depth=feed_depth,
        lazy_publish=lazy_publish, budget_s=args.budget_s,
        pipeline_blocks=args.pipeline_blocks,
        pipeline_coalesce_max=args.pipeline_coalesce_max,
        pipeline_feed_depth=args.pipeline_feed_depth,
        pipeline_lazy=(None if args.pipeline_lazy_publish == "auto"
                       else args.pipeline_lazy_publish == "on"),
        seed=args.seed, device=args.device, reference_impl=args.reference,
        emit=emit)

    regressions = check_regression(record, committed,
                                   min_frac=args.min_regression_frac,
                                   emit=emit)

    Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
    emit("serve_json", args.out, "written")
    s = record["summary"]
    emit("min_ingest_ratio", f"{s['min_ingest_ratio']:.3f}")
    emit("worst_p99_s", f"{s['worst_p99_s']:.4e}")
    emit("all_equivalent", str(s["all_equivalent"]).lower())
    emit("all_lazy_eager_equivalent",
         str(s["all_lazy_eager_equivalent"]).lower())
    emit("best_pipeline_gain", f"{s['best_pipeline_gain']:.3f}")

    if args.check:
        failures = check_record(record, min_ratio=args.min_ingest_ratio,
                                p50_slo=args.p50_slo, p99_slo=args.p99_slo)
        failures += regressions
        if failures:
            for f in failures:
                print(f"CHECK FAILED: {f}", file=sys.stderr)
            return 1
        print("check,ok,SLO + bitwise + accounting + regression gates "
              "hold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
