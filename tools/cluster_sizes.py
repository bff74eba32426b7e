"""Times of the fused kernels' cluster path at every cluster size, on one CUDA card.

    PYTHONPATH=src python tools/cluster_sizes.py [--reps 20]

For each case (a flush ``ingest,B,k,W`` or a COMBINE ``combine,B,k``, int32
counts unless ``,int64`` follows;
default: the shapes the engine, the paper's k sweep and ``chip_smoke.py``
run above the shared-memory path's limits) the same inputs go through the
cluster kernel at every size C in ``ss_ingest.CLUSTER_SIZES`` that holds the
shape (``ss_ingest.cluster_fits``), and through the workspace kernel; every
output is held bit for bit against the plain version. Prints one JSON line
a case: the ms a call of each (CUDA events over a loop of wrapper calls,
host work included) and its device ms (the kernel alone under
``torch.profiler``), ``cudaOccupancyMaxActiveClusters`` at each C, the size
``ss_ingest.cluster_for`` picks, the path ``ss_ingest.path_for`` picks and
the fastest size measured; then the card's name and power limit. This is
what the rules of ``cluster_for`` and ``path_for`` were set from.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import ref, ss_ingest

DEFAULT_CASES = (
    "ingest,64,2048,65536", "ingest,2,2048,65536", "ingest,8,4000,16384",
    "ingest,8,8000,16384", "ingest,64,4000,16384", "ingest,64,8000,16384",
    "ingest,64,8000,16384,int64", "ingest,2,16384,131072", "combine,8,4000",
    "combine,8,8000", "combine,8,16384", "combine,1,8000", "combine,2,8000", "combine,4,8000",
    "combine,16,4000", "combine,16,8000", "combine,32,4000", "combine,32,8000")


def summary(rng, b, k, dev, dtype):
    """(B, k) summaries of distinct ids over 4k with counts in [1, 1000)."""
    items = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)]).astype(np.int32)
    counts = rng.integers(1, 1000, (b, k))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (items, counts.astype(dtype), (counts // 4).astype(dtype)))


def event_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel):
    """Device time of one launch of the CUDA kernel whose name holds ``kernel``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(getattr(ev, "device_time_total", None) or ev.cuda_time_total, ev.count)
            for ev in prof.key_averages() if kernel in ev.key]
    if not hits:
        return None
    return sum(t for t, _ in hits) / sum(n for _, n in hits) / 1e3


def run_case(spec, reps, rng, dev):
    kernel, *dims = spec.split(",")
    wide = dims[-1] == "int64"
    dims = dims[:-1] if wide else dims
    b, k = int(dims[0]), int(dims[1])
    w = int(dims[2]) if kernel == "ingest" else 0
    dtype, tdtype = (np.int64, torch.int64) if wide else (np.int32, torch.int32)
    s = summary(rng, b, k, dev, dtype)
    if kernel == "ingest":
        win = np.minimum(rng.zipf(1.1, (b, w)), 10**6).astype(np.int32)
        win[rng.random((b, w)) < 0.05] = -1
        args = (*s, torch.from_numpy(win).to(dev))
        fn, plain = ss_ingest._fused_ingest, ref.fused_ingest_ref
    else:
        args = (*s, *summary(rng, b, k, dev, dtype))
        fn, plain = ss_ingest._fused_combine, ref.fused_combine_ref
    want = plain(*args)

    def held(got):
        torch.cuda.synchronize()
        for g, x in zip(got, want, strict=True):
            if not torch.equal(g, x):
                raise AssertionError(f"{spec}: kernel output is not bitwise its plain version")

    row = {"case": spec, "cluster_for": ss_ingest.cluster_for(k, w, b, tdtype),
           "path_for": ss_ingest.path_for(k, w, b, tdtype), "ms": {}, "device_ms": {},
           "occupancy": {}}
    for c in ss_ingest.CLUSTER_SIZES:
        if not ss_ingest.cluster_fits(k, w, c, tdtype):
            continue
        held(fn(*args, path="cluster", c=c))
        row["ms"][c] = event_ms(lambda c=c: fn(*args, path="cluster", c=c), reps)
        row["device_ms"][c] = device_ms(lambda c=c: fn(*args, path="cluster", c=c), reps,
                                        "cluster_kernel")
        row["occupancy"][c] = ss_ingest.cluster_occupancy(kernel, tdtype, k, w, c)
    held(fn(*args, path="workspace"))
    row["workspace_ms"] = event_ms(lambda: fn(*args, path="workspace"), reps)
    row["workspace_device_ms"] = device_ms(lambda: fn(*args, path="workspace"), reps,
                                           "workspace_kernel")
    row["fastest"] = (min(row["device_ms"], key=row["device_ms"].get)
                      if row["device_ms"] else None)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=";".join(DEFAULT_CASES),
                    help="';'-separated cases: ingest,B,k,W or combine,B,k")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/cluster_sizes.py needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for spec in args.cases.split(";"):
        print(json.dumps(run_case(spec, args.reps, rng, dev)), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
