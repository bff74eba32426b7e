"""Metrics dump CLI — watch a live ServingTier's observable surface.

The counterpart of ``repro.launch.metrics``. Runs a small seeded tier
(zipf stream through the full submit → ingest → publish path, plus a few
frontend reads so every read histogram has samples) on one device and
prints what a live deployment would export (DESIGN.md §12):

  ``--format json``   ``ServingTier.describe()`` — config, consistent
                      ingest stats, the tier registry dump, the latest
                      sketch-native health — plus the process-default
                      registry (engine / runtime / plan counters);
  ``--format prom``   both registries in Prometheus text exposition
                      format (the scrape-endpoint view);
  ``--events N``      additionally print the last N tier trace events as
                      JSON lines (the span ring).

``--watch`` switches to the drift-sentinel live view (DESIGN.md §14):
the tier ingests a paced zipf stream for ``--duration`` seconds while
one status line per ``--refresh`` interval reports the windowed
time-series aggregates (ingest rate, queue depth), the latest health
(n, live ε fraction) and drift (estimated skew ± CI, churn) frames, and
any firing alerts; new trace events stream incrementally underneath via
``Tracer.export(since_event_id=...)``. ``--dump-flight PATH`` writes
the flight-recorder artifact at the end of either mode.

  python -m repro_torch.launch.metrics                      # JSON dump, on the card
  python -m repro_torch.launch.metrics --device cpu --format prom
  python -m repro_torch.launch.metrics --device cpu --events 32
  python -m repro_torch.launch.metrics --device cpu --watch --duration 5
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _build_tier(*, k, lanes, chunk, depth, publish_every, ring_depth,
                kmaj, device, flight_path=None):
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import RuntimeConfig
    from repro_torch.serve import ServeConfig, ServingTier

    cfg = ServeConfig(
        runtime=RuntimeConfig(
            engine=EngineConfig(k=k, tenants=lanes, chunk=chunk,
                                buffer_depth=depth, device=str(device)),
            shards=1),
        publish_every=publish_every, ring_depth=ring_depth,
        health_k_majority=kmaj,
        **({"flight_path": flight_path} if flight_path else {}))
    return ServingTier(cfg)


def run_tier_dump(*, k=256, lanes=2, chunk=512, depth=2, blocks=16,
                  layers=2, publish_every=2, ring_depth=4, kmaj=64,
                  seed=0, device="cuda", flight_path=None):
    """One small tier run → (describe dict, tier registry, tier tracer).

    With ``flight_path``, additionally dumps the flight-recorder
    artifact there before the tier shuts down.
    """
    import numpy as np

    from repro_torch.data.synthetic import zipf_stream

    tier = _build_tier(k=k, lanes=lanes, chunk=chunk, depth=depth,
                       publish_every=publish_every, ring_depth=ring_depth,
                       kmaj=kmaj, device=device, flight_path=flight_path)
    block_items = tier.runtime.workers * chunk * layers
    queries = np.random.default_rng(seed).integers(0, 10**5, size=8).astype(np.int32)
    with tier:
        for i in range(blocks):
            tier.submit(zipf_stream(block_items, 1.2, seed=seed + i, max_id=10**5))
        tier.drain()
        # exercise every read op so serve.read.* histograms have samples
        tier.frontend.estimate(queries)
        tier.frontend.top_table(10)
        tier.frontend.k_majority_report(kmaj)
        tier.health_report()
        desc = tier.describe()
        if flight_path:
            tier.dump_flight_record(flight_path)
    return desc, tier.registry, tier.tracer


def _status_line(t_s, tier, store) -> str:
    from repro_torch.obs.trace import fmt_event

    fields = {"t_s": t_s}
    rate = store.value("serve.ingest.blocks", "rate", 2.0)
    depth = store.value("serve.ingest.queue_depth", "mean", 2.0)
    if rate is not None:
        fields["blk_per_s"] = rate
    if depth is not None:
        fields["queue"] = depth
    h = tier.health.latest() if tier.health is not None else None
    if h:
        fields["n"] = h["n"]
        fields["eps_frac"] = h["epsilon_frac"]
        fields["occ"] = h["occupancy_frac"]
    d = tier.drift.latest() if tier.drift is not None else None
    if d and d.get("skew") == d.get("skew"):        # skew is not NaN
        fields["skew"] = d["skew"]
        ci = d.get("skew_ci_high")
        if ci is not None and ci == ci:
            fields["skew_ci"] = ci - d["skew"]
        churn = d.get("top_churn")
        if churn is not None and churn == churn:
            fields["churn"] = churn
    firing = tier.alerts.active() if tier.alerts is not None else []
    if firing:
        fields["alerts"] = ",".join(a["rule"] for a in firing)
    return fmt_event("watch", fields)


def run_watch(*, k=256, lanes=2, chunk=512, depth=2, layers=2,
              publish_every=2, ring_depth=4, kmaj=64, seed=0,
              duration=5.0, refresh_s=0.5, skew=1.2, events=False,
              device="cuda", flight_path=None, _printer=print):
    """Live sentinel view: paced ingest + one status line per refresh.

    Returns the final ``describe()`` dict. The producer (this thread)
    paces block submission across ``duration`` seconds so the windowed
    rates are meaningful; each refresh prints the sentinel surface and,
    with ``events``, streams new trace events via incremental export.
    """
    from repro_torch.data.synthetic import zipf_stream

    tier = _build_tier(k=k, lanes=lanes, chunk=chunk, depth=depth,
                       publish_every=publish_every, ring_depth=ring_depth,
                       kmaj=kmaj, device=device, flight_path=flight_path)
    store = tier.registry.timeseries
    block_items = tier.runtime.workers * chunk * layers
    last_event_id = 0
    with tier:
        t0 = time.perf_counter()
        next_refresh = t0 + refresh_s
        i = 0
        while True:
            now = time.perf_counter()
            if now - t0 >= duration:
                break
            tier.submit(zipf_stream(block_items, skew, seed=seed + i, max_id=10**5))
            i += 1
            if now >= next_refresh:
                next_refresh = now + refresh_s
                _printer(_status_line(round(now - t0, 2), tier, store))
                if events:
                    out = tier.tracer.export(since_event_id=last_event_id, last=8)
                    if out:
                        _printer(out)
                        last_event_id = max(e["id"] for e in tier.tracer.events())
        tier.drain()
        tier.health_report()
        _printer(_status_line(round(time.perf_counter() - t0, 2), tier, store))
        desc = tier.describe()
        if flight_path:
            path = tier.dump_flight_record(flight_path)
            _printer(f"[watch] flight record -> {path}")
    return desc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the tier runs: cuda (default) or cpu")
    ap.add_argument("--format", default="json", choices=("json", "prom"))
    ap.add_argument("--events", type=int, default=0,
                    help="also print the last N trace events (JSON lines)")
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--publish-every", type=int, default=2)
    ap.add_argument("--ring-depth", type=int, default=4)
    ap.add_argument("--k-majority", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--watch", action="store_true",
                    help="live sentinel view: paced ingest with one "
                         "status line per refresh")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="--watch run length in seconds")
    ap.add_argument("--refresh", type=float, default=0.5,
                    help="--watch status-line interval in seconds")
    ap.add_argument("--skew", type=float, default=1.2,
                    help="--watch zipf skew of the synthetic stream")
    ap.add_argument("--dump-flight", default=None, metavar="PATH",
                    help="write the flight-recorder artifact here at "
                         "the end of the run")
    args = ap.parse_args(argv)

    from repro_torch.obs import metrics as obs_metrics

    if args.watch:
        run_watch(
            k=args.k, lanes=args.lanes, chunk=args.chunk,
            depth=args.depth, layers=args.layers,
            publish_every=args.publish_every, ring_depth=args.ring_depth,
            kmaj=args.k_majority, seed=args.seed,
            duration=args.duration, refresh_s=args.refresh,
            skew=args.skew, events=bool(args.events), device=args.device,
            flight_path=args.dump_flight)
        return 0

    desc, registry, tracer = run_tier_dump(
        k=args.k, lanes=args.lanes, chunk=args.chunk, depth=args.depth,
        blocks=args.blocks, layers=args.layers,
        publish_every=args.publish_every, ring_depth=args.ring_depth,
        kmaj=args.k_majority, seed=args.seed, device=args.device,
        flight_path=args.dump_flight)

    if args.format == "prom":
        sys.stdout.write(registry.prometheus())
        sys.stdout.write(obs_metrics.DEFAULT.prometheus())
    else:
        print(json.dumps(
            {"tier": desc, "process": obs_metrics.DEFAULT.describe()},
            indent=2, default=str))
    if args.events:
        out = tracer.to_jsonl(last=args.events)
        if out:
            print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
