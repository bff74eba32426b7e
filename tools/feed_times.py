"""Where ``StreamRuntime.feed`` spends its time, on one CUDA card.

    PYTHONPATH=src python tools/feed_times.py [--blocks 16] [--block-ids 4194304]
        [--reps 3] [--trace-dir DIR]

At ``chip_smoke.py``'s runtime geometry (64 lanes, k 2048, C 2048, T 8,
one shard), over a zipf(1.1) stream cut into host (numpy) blocks, for each
kernel (``fused``, what ``auto`` takes under the card's measured plan, and
``cuda``):

* ``feed`` items/s at depths 1, 2 and 4, ``reps`` times each, and
  ``ingest`` items/s of the same blocks staged on the card beforehand
  (host clock after a device sync);
* the host clock of each step of the feed loop, from the public pieces
  it is made of: ``host_blocks``, ``DeviceStager.stage`` (the copy into a
  pinned buffer and the enqueue of its copy), ``DeviceStager.take`` and
  the engine's ``ingest`` dispatch, summed over the blocks;
* one feed at depth 2 under ``torch.profiler`` (CPU and CUDA): the device
  busy time and idle share over the feed (its span ends after a sync), the
  host-to-device copies' time and the share of it that overlaps a kernel,
  and the host time and count of the CUDA runtime calls that cost the most
  (a ``cudaStreamSynchronize`` there is the host waiting for the card).

Prints one JSON line per kernel, then the card's name and power limit.
With ``--trace-dir`` the profiles are kept as Chrome traces.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch

LANES, K, CHUNK, DEPTH = 64, 2048, 2048, 8


def synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def union(intervals):
    """Disjoint, sorted [start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals, cover) -> float:
    """Total length of ``intervals`` that lies inside the union ``cover``."""
    total = 0.0
    for s, e in intervals:
        for cs, ce in cover:
            total += max(0.0, min(e, ce) - max(s, cs))
    return total


def profile_feed(rt, blocks, trace_path):
    """Device busy, idle share and copy overlap of one feed (µs from the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import Tracer
    tracer = Tracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracer.span("runtime.feed"):
            rt.feed(rt.init(), iter(blocks))
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    span = next(e for e in events if e.get("name") == "runtime.feed" and "dur" in e
                and e.get("cat") == "user_annotation")
    lo, hi = span["ts"], span["ts"] + span["dur"]

    def device(cat, name=""):
        return [(max(lo, e["ts"]), min(hi, e["ts"] + e["dur"])) for e in events
                if e.get("cat") == cat and name in e.get("name", "") and "dur" in e
                and e["ts"] < hi and e["ts"] + e["dur"] > lo]

    kernels, copies = device("kernel"), device("gpu_memcpy") + device("gpu_memset")
    h2d = device("gpu_memcpy", "HtoD")
    busy = sum(e - s for s, e in union(kernels + copies))
    h2d_us = sum(e - s for s, e in h2d)
    runtime_calls = {}                      # name -> [µs, calls]
    for e in events:
        if e.get("cat") == "cuda_runtime" and "dur" in e and lo <= e["ts"] < hi:
            hit = runtime_calls.setdefault(e["name"], [0.0, 0])
            hit[0] += e["dur"]
            hit[1] += 1
    top = sorted(runtime_calls.items(), key=lambda kv: -kv[1][0])[:8]
    return {"feed_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (hi - lo),
            "kernel_ms": sum(e - s for s, e in union(kernels)) / 1e3,
            "h2d_ms": h2d_us / 1e3, "h2d_copies": len(h2d),
            "h2d_overlapping_a_kernel_share": (covered(h2d, union(kernels)) / h2d_us
                                               if h2d_us else None),
            "host_runtime_calls": {name: {"ms": us / 1e3, "calls": calls}
                                   for name, (us, calls) in top}}


def step_split(rt, blocks, depth):
    """Host seconds of each step of the feed loop, summed over the blocks."""
    from repro_torch.runtime import DeviceStager, host_blocks
    steps = dict.fromkeys(("host_blocks", "stage", "take", "ingest"), 0.0)
    stager = DeviceStager(device="cuda", depth=depth)
    state = rt.init()
    t_start = synced()

    def consume():
        nonlocal state
        t0 = time.perf_counter()
        block, _ = stager.take()
        t1 = time.perf_counter()
        state = rt.engine.ingest(state, block)
        t2 = time.perf_counter()
        steps["take"] += t1 - t0
        steps["ingest"] += t2 - t1

    for b in blocks:
        t0 = time.perf_counter()
        hb = host_blocks(b, rt.workers, CHUNK)[rt.rows]
        t1 = time.perf_counter()
        stager.stage(hb)
        steps["host_blocks"] += t1 - t0
        steps["stage"] += time.perf_counter() - t1
        if not stager.room:
            consume()
    while len(stager):
        consume()
    steps["total_with_sync"] = synced() - t_start
    return {k: v * 1e3 for k, v in steps.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--block-ids", type=int, default=1 << 22)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("feed_times: needs a CUDA card")

    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import RuntimeConfig, StreamRuntime, host_blocks

    n = args.blocks * args.block_ids
    stream = zipf_stream(n, 1.1, seed=0, max_id=10**6)
    blocks = [stream[i:i + args.block_ids] for i in range(0, n, args.block_ids)]
    def runtime(kernel, depth):
        return StreamRuntime(RuntimeConfig(
            engine=EngineConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH,
                                kernel=kernel), shards=1, feed_depth=depth))

    with tempfile.TemporaryDirectory(prefix="feed-times-") as tmp:
        trace_dir = Path(args.trace_dir or tmp)
        trace_dir.mkdir(parents=True, exist_ok=True)
        for kernel in ("fused", "cuda"):
            rt = runtime(kernel, 2)
            rt.feed(rt.init(), iter(blocks[:2]))          # warm: build, allocator, pinned pool
            rates = {}
            for depth in (1, 2, 4):
                rt = runtime(kernel, depth)
                rates[f"feed_depth{depth}"] = []
                for _ in range(args.reps):
                    t0 = synced()
                    rt.feed(rt.init(), iter(blocks))
                    rates[f"feed_depth{depth}"].append(n / (synced() - t0))
            staged = [torch.from_numpy(host_blocks(b, rt.workers, CHUNK)).cuda()
                      for b in blocks]
            rates["ingest"] = []
            for _ in range(args.reps):
                t0 = synced()
                state = rt.init()
                for b in staged:
                    state = rt.ingest(state, b)
                rates["ingest"].append(n / (synced() - t0))
            del staged
            split = {f"depth{d}": step_split(runtime(kernel, d), blocks, d) for d in (1, 2)}
            prof = profile_feed(runtime(kernel, 2), blocks, trace_dir / f"feed_{kernel}.json")
            print(json.dumps({"kernel": kernel, "ids": n, "blocks": args.blocks,
                              "items_per_s": rates, "host_steps_ms": split,
                              "profiled_feed_depth2": prof}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
