"""Where the serving tier's time goes, on one CUDA card.

    PYTHONPATH=src python tools/serve_times.py [--blocks 64] [--block-ids 1048576]
        [--reps 2] [--switch-ms 5,0.5] [--trace-dir DIR]

At ``chip_smoke.py``'s serving geometry (64 lanes, k 2048, C 2048, T 8, one
shard; publish every 8 blocks, ring depth 4, feed depth 2, eager
publishes), over a zipf(1.1) stream cut into host (numpy) blocks of 2^20
ids, for each kernel (``fused``, what ``auto`` takes under the card's
measured plan, and ``cuda``) and each interpreter thread-switch interval
(``sys.setswitchinterval``, in ms):

* the baseline (no readers) and loaded (4 readers at 50 qps) phases of
  ``launch/bench_serve``, ``reps`` times each: updates/s, the loop
  thread's host seconds in its ingest steps and in its publishes (sums of
  ``serve.ingest.step_s`` and ``serve.ingest.publish_s``), the reads'
  p50/p99 per op, and the sentinel threads' host copies;
* the same two phases with ``metrics=False`` (no sentinel threads, no
  instruments): updates/s only;
* reads with nothing else running (a tier fed 8 blocks and drained, then
  20 reads of each op from one thread): p50/p99 per op;
* one loaded phase under ``torch.profiler`` (CPU and CUDA): the device's
  busy time (kernels, copies and memsets, their union) against the phase's
  wall time, and the kernel time by name.

Prints one JSON line per kernel and switch interval, then the card's name
and power limit. With ``--trace-dir`` the profiles are kept as Chrome
traces.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from feed_times import union

LANES, K, CHUNK, DEPTH = 64, 2048, 2048, 8
SERVE = dict(publish_every=8, ring_depth=4, queue_depth=8, admission="block",
             kmaj=64, coalesce_max=1, feed_depth=2, lazy_publish=False)


def phase(rt, blocks, flight, readers, queries, metrics=True):
    """One tier phase of bench_serve, reduced to the numbers kept here
    (with ``metrics=False`` only the rate: nothing else is recorded)."""
    from repro_torch.launch import bench_serve
    out = bench_serve._run_tier(rt, blocks, readers=readers, qps=50.0 if readers else 0.0,
                                queries=queries, flight_path=flight, metrics=metrics,
                                **SERVE)
    pipe = out["pipeline"]
    items = sum(int(b.size) for b in blocks)
    if not metrics:
        return {"elapsed_s": out["elapsed_s"], "updates_per_s": items / out["elapsed_s"]}
    return {"elapsed_s": out["elapsed_s"], "updates_per_s": items / out["elapsed_s"],
            "loop_step_s": pipe["step_s"]["sum"], "loop_steps": pipe["step_s"]["count"],
            "loop_publish_s": pipe["publish_s"]["sum"],
            "publishes": pipe["publish_s"]["count"],
            "sentinel_host_copies": pipe["sentinel_host_copies"],
            "reads": {op: {"count": q["count"], "p50_s": q["p50_s"], "p99_s": q["p99_s"]}
                      for op, q in out["queries"].items()}}


def quiet_reads(rt, blocks, flight, queries, reps=20):
    """Read latency with nothing else running: a tier fed ``blocks`` and
    drained, then ``reps`` reads of each op from this thread."""
    from repro_torch.serve import ServeConfig, ServingTier
    cfg = ServeConfig(runtime=rt.config, flight_path=flight, **{
        k: v for k, v in SERVE.items() if k not in ("kmaj", "feed_depth")})
    with ServingTier(cfg, runtime=rt) as tier:
        for b in blocks:
            tier.submit(b)
        tier.drain()
        tier.loop.sync()
        tier.health.refresh()
        for _ in range(reps):
            tier.frontend.estimate(queries)
            tier.frontend.top_table(10)
            tier.frontend.k_majority_report(SERVE["kmaj"])
        return {op: {"count": d["count"], "p50_s": d["p50"], "p99_s": d["p99"]}
                for op in ("point", "top", "kmaj")
                for d in [tier.registry.histogram(f"serve.read.{op}_s").describe()]}


def profiled(rt, blocks, flight, queries, trace_path):
    """Device busy over one loaded phase, from its profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = phase(rt, blocks, flight, 4, queries)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text())["traceEvents"]

    def spans(cat):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == cat and "dur" in e]

    kernels = spans("kernel")
    busy_us = sum(e - s for s, e in union(kernels + spans("gpu_memcpy")
                                          + spans("gpu_memset")))
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            hit = by_name.setdefault(e["name"][:70], [0.0, 0])
            hit[0] += e["dur"]
            hit[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"phase": got, "window_s": window_s, "device_busy_ms": busy_us / 1e3,
            "device_busy_share_of_phase": busy_us / 1e6 / got["elapsed_s"],
            "kernel_ms": {name: {"ms": us / 1e3, "launches": n} for name, (us, n) in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--block-ids", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--switch-ms", default="5,0.5")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_times: needs a CUDA card")

    import numpy as np

    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import RuntimeConfig, StreamRuntime

    n = args.blocks * args.block_ids
    stream = zipf_stream(n, 1.1, seed=0, max_id=10**6)
    blocks = [stream[i:i + args.block_ids] for i in range(0, n, args.block_ids)]
    queries = np.random.default_rng(0).integers(0, 10**6, size=8).astype(np.int32)
    default_switch = sys.getswitchinterval()
    with tempfile.TemporaryDirectory(prefix="serve-times-") as tmp:
        trace_dir = Path(args.trace_dir or tmp)
        trace_dir.mkdir(parents=True, exist_ok=True)
        flight = str(Path(tmp) / "flight.json")
        for kernel in ("fused", "cuda"):
            rt = StreamRuntime(RuntimeConfig(engine=EngineConfig(
                k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH, kernel=kernel),
                shards=1))
            phase(rt, blocks[:2], flight, 4, queries)     # warm: builds, first launches, pinned pool
            for ms in (float(x) for x in args.switch_ms.split(",")):
                sys.setswitchinterval(ms / 1e3)
                try:
                    runs = {name: [phase(rt, blocks, flight, readers, queries, metrics)
                                   for _ in range(args.reps)]
                            for name, readers, metrics in (
                                ("baseline", 0, True), ("loaded", 4, True),
                                ("baseline_metrics_off", 0, False),
                                ("loaded_metrics_off", 4, False))}
                    quiet = quiet_reads(rt, blocks[:8], flight, queries)
                    prof = profiled(rt, blocks, flight, queries,
                                    trace_dir / f"serve_{kernel}_{ms:g}ms.json")
                finally:
                    sys.setswitchinterval(default_switch)
                print(json.dumps({"kernel": kernel, "switch_interval_ms": ms, "ids": n,
                                  "blocks": args.blocks, "runs": runs,
                                  "quiet_reads": quiet, "profiled_loaded": prof}),
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
