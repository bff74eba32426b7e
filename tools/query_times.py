"""Times of the port's point-query kernel at chosen shapes, on one CUDA card.

Calls only the public wrapper ``repro_torch.kernels.ss_query.query``, so it
runs against any checkout of the port: the package is the one on
``PYTHONPATH``. That lets two commits be compared in one session on one
card, for example a parent and a change, alternately::

    PYTHONPATH=parent/src python tools/query_times.py --tag parent
    PYTHONPATH=src python tools/query_times.py --tag change

Each case (``B,k,q,dtype``; default: the shapes the shape rule gives the
dense kernel) is held bit for bit against ``query_ref`` and timed twice:
"ms" is CUDA-event time per wrapper call over a loop (host checks
included), "device_ms" the kernel alone under ``torch.profiler``. Prints
one JSON line per case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

DEFAULT_CASES = ("2,8193,256,int32", "1,16384,256,int32", "2,4097,256,int64",
                 "2,6144,256,int64")


def inputs(rng, b, k, q, dtype, dev):
    """B rows of k distinct ids with random counts, and q queries a row of
    which half are ids of the row."""
    items = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)]).astype(np.int32)
    counts = rng.integers(0, 1000, (b, k)).astype(dtype)
    hits = items[np.arange(b)[:, None], rng.integers(0, k, (b, q // 2))]
    queries = np.concatenate([hits, rng.integers(-1, 4 * k, (b, q - q // 2))], axis=1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (items, counts, counts // 3, queries.astype(np.int32)))


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


def device_ms(fn, reps):
    """Device time of one launch of the query kernel (any name holding
    "query"), from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(getattr(ev, "device_time_total", 0.0), ev.count, ev.key)
            for ev in prof.key_averages() if "query" in ev.key]
    hits = [h for h in hits if h[0] > 0]
    return sum(t for t, _, _ in hits) / sum(n for _, n, _ in hits) / 1e3, \
        sorted({key for _, _, key in hits})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(DEFAULT_CASES),
                    help="B,k,q,dtype (dtype int32 or int64)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="", help="a label copied into every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("query_times: no CUDA card")
    from repro_torch.kernels import ref, ss_query

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    for case in args.cases:
        b, k, q, dtype = case.split(",")
        t = inputs(rng, int(b), int(k), int(q), np.dtype(dtype), dev)
        got = ss_query.query(*t)
        want = ref.query_ref(*t)
        equal = all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        dev_ms, names = device_ms(lambda: ss_query.query(*t), args.reps)
        print(json.dumps({"tag": args.tag, "case": case, "bitwise_equal": equal,
                          "ms": event_ms(lambda: ss_query.query(*t), args.reps),
                          "device_ms": dev_ms, "kernels": names}), flush=True)
        if not equal:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
