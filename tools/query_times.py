"""Times of the port's point-query and hash-join kernels at chosen shapes, on
one CUDA card.

Calls only the public wrappers ``repro_torch.kernels.ss_query.query`` and
``repro_torch.kernels.ss_combine.combine_match``, so it runs against any
checkout of the port: the package is the one on ``PYTHONPATH``. That lets
two commits be compared in one sitting on one card, for example a parent
and a change, alternately::

    PYTHONPATH=parent/src python tools/query_times.py --tag parent
    PYTHONPATH=src python tools/query_times.py --tag change

A case is ``B,k,q,dtype`` (a query of B rows of k ids, q queries a row;
default: the shapes the shape rule gives the dense kernel) or one of the
main path's hash joins (:data:`HASH_JOIN_CASES`): ``combine_flush``, the
combine-match at the flush shape (B 64, k 2048, c 16 384 int32: the
histogram of a zipf(1.1) W 16 384 window, no errors channel),
``combine_combine`` at the COMBINE shape (B 32, k = c = 2048, errors) and
``query_bucket``, the query at the main path's bucket (B 1, k 2048,
q 256). Each is held bit for bit against its plain version and timed
twice: "ms" is CUDA-event time per wrapper call over a loop (host checks
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
HASH_JOIN_CASES = ("combine_flush", "combine_combine", "query_bucket")


def on_card(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def query_inputs(rng, b, k, q, dtype, dev):
    """B rows of k distinct ids with random counts, and q queries a row of
    which half are ids of the row."""
    items = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)]).astype(np.int32)
    counts = rng.integers(0, 1000, (b, k)).astype(dtype)
    hits = items[np.arange(b)[:, None], rng.integers(0, k, (b, q // 2))]
    queries = np.concatenate([hits, rng.integers(-1, 4 * k, (b, q - q // 2))], axis=1)
    return tuple(on_card(a, dev) for a in (items, counts, counts // 3, queries.astype(np.int32)))


def hash_join_inputs(rng, case, dev):
    """The inputs of one of :data:`HASH_JOIN_CASES`."""
    def rows(b, k, id_range):
        return on_card(np.stack([rng.permutation(id_range)[:k] for _ in range(b)])
                       .astype(np.int32), dev)

    if case == "combine_flush":
        window = np.minimum(rng.zipf(1.1, (64, 16384)), 10**6).astype(np.int32)
        h_items, h_weights = [], []
        for r in window:                  # the window's exact histogram, EMPTY-padded
            ids, w = np.unique(r, return_counts=True)
            h_items.append(np.pad(ids, (0, 16384 - len(ids)), constant_values=-1))
            h_weights.append(np.pad(w, (0, 16384 - len(w))))
        return (rows(64, 2048, 8 * 2048), on_card(np.stack(h_items).astype(np.int32), dev),
                on_card(np.stack(h_weights).astype(np.int32), dev), None)
    if case == "combine_combine":
        pair = (rows(32, 2048, 4096), rows(32, 2048, 4096),
                on_card(rng.integers(0, 1000, (32, 2048)).astype(np.int32), dev))
        return (*pair, pair[2] // 3)
    items = rows(1, 2048, 8192)
    queries = np.concatenate([items.cpu().numpy()[:, :128], rng.integers(-1, 8192, (1, 128))],
                             axis=1).astype(np.int32)
    counts = on_card(rng.integers(0, 1000, (1, 2048)).astype(np.int32), dev)
    return (items, counts, counts // 3, on_card(queries, dev))


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


def device_ms(fn, reps, name):
    """Device time of one launch of the kernels whose names hold ``name``,
    from the profiler, and those names."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(getattr(ev, "device_time_total", 0.0), ev.count, ev.key)
            for ev in prof.key_averages() if name in ev.key]
    hits = [h for h in hits if h[0] > 0]
    return sum(t for t, _, _ in hits) / sum(n for _, n, _ in hits) / 1e3, \
        sorted({key for _, _, key in hits})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(DEFAULT_CASES),
                    help=f"B,k,q,dtype (dtype int32 or int64), or one of {HASH_JOIN_CASES}")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tag", default="", help="a label copied into every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("query_times: no CUDA card")
    from repro_torch.kernels import ref, ss_combine, ss_query

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    for case in args.cases:
        if case in HASH_JOIN_CASES:
            t = hash_join_inputs(rng, case, dev)
            fn, plain, name = ((ss_query.query, ref.query_ref, "query_hash_kernel")
                               if case == "query_bucket" else
                               (ss_combine.combine_match, ref.combine_match_ref,
                                "combine_hash_kernel"))
        else:
            b, k, q, dtype = case.split(",")
            t = query_inputs(rng, int(b), int(k), int(q), np.dtype(dtype), dev)
            fn, plain, name = ss_query.query, ref.query_ref, "query"
        got, want = fn(*t), plain(*t)
        equal = all((g is None and w is None) or (g is not None and w is not None
                                                  and torch.equal(g, w))
                    for g, w in zip(got, want, strict=True))
        dev_ms, names = device_ms(lambda: fn(*t), args.reps, name)
        print(json.dumps({"tag": args.tag, "case": case, "bitwise_equal": equal,
                          "ms": event_ms(lambda: fn(*t), args.reps),
                          "device_ms": dev_ms, "kernels": names}), flush=True)
        if not equal:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
