#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Five phases, each printing one JSON line or more:

1. device and build: the card's name and power limit, and one ``nvcc`` per
   source of ``src/repro_torch/csrc/``, all started together;
2. every kernel against its plain PyTorch version at the main path's
   shapes, bit for bit (integer sums: no tolerance), with CUDA-event times
   of the kernel and of the plain version, and the function's bound (bytes
   moved, or the operations of a hash join, whichever takes longer): the
   combine-match kernel (its hash join at the flush, COMBINE and planned
   shapes, duplicates, int64 counts and 65 537 batch entries, and the dense
   kernel it keeps for large k at the flush, COMBINE and planned shapes),
   the query kernels (the main path's bucket, q 16, q 4096, 65 537 batch
   entries, int64 counts, duplicate ids with counts of 0, sums that wrap,
   k 8193 at int32 and k 6144 at int64 above the hash table's limit, k 64
   rows; and the dense kernel forced at shapes the rule gives the hash
   kernel), match-weights,
   which launches the combine-match kernels with no errors channel (the
   tune cell, the flush histogram's batched shape, duplicate and EMPTY ids,
   wrapping int32 and int64 weights, a ragged shape, an empty histogram,
   and k 8193, above the hash table's limit), then the fused flush and fused COMBINE (flush and COMBINE shapes, int64
   counts, an all-EMPTY window, tied counts, a partly empty summary, a
   ragged shape; and for the flush kernel's radix sorts ids over the whole
   int32 range, windows whose high digits are constant or whose digits all
   vary, W not a power of two, all-equal and all-distinct windows, counts
   above 2^24 and 2^32 with ties in low digits);
3. the main path at real size — zipf stream of 2^26 ids over 64 tenants,
   k = 2048, C = 2048, T = 8, skews 1.1 and 1.8 — with ``impl="cuda"``,
   ``impl="sorted"`` and ``impl="fused"``: identical snapshots, guaranteed
   recall and recall 1.0, no bound violations, and every kernel launched;
   then flush, snapshot and query latency for each impl, and the
   host/device split of one ``QueryFrontend.estimate`` under ``cuda`` at
   q 16 and q 4096 (profiler device time against the host clock, and the
   host clock of each public step: the frontend's padding, ``ops.query``,
   the ``ss_query`` wrapper within it, ``bounded_estimates``, the copy
   back);
4. the tune CLI (``repro_torch.launch.tune --check``) in this process: it
   measures the dispatch surface on the card (update, combine, query and
   flush; torch, sorted, cuda and fused), writes a plan under a temporary
   directory and must pass its tolerance and bitwise gates; the plan's
   tables, chunk, query bucket floor and gate margins are printed;
5. the main path of phase 3 again with ``kernel="auto"`` under that plan:
   snapshots identical to ``sorted``'s, the guarantees held, the impl
   ``auto`` took for each op, its ingest rate beside the fixed impls' and
   its flush, snapshot and query latency; then an engine on the plan's own
   geometry (``planned_engine_config``: its chunk and buffer depth) for a
   few windows, its resolved flush impl, its snapshot held against a
   ``sorted`` engine's of the same geometry, and its flush, snapshot and
   query latency.

Each path (3, 4, 5 and the planned engine) runs with the kernels' launch
counts set to 0 just before it and read just after. Then the kernel table as one JSON line, the
card's name and power limit, and as the last line ``{"ok": true, "device":
{...}}``. Any failed check raises, so the exit code is not 0 and no result
line is printed. Without a CUDA card, or without the rest of the
repository beside it, it exits 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12     # H100 non-tensor-core float32 peak, used for int32 compares
N_MAIN = 1 << 26             # ids in the main-path stream (256 MiB of int32 on the card)
TENANTS, K, CHUNK, DEPTH = 64, 2048, 2048, 8
SKEWS = (1.1, 1.8)           # the paper's Table I
MAX_ID = 10**6
IMPLS = ("cuda", "sorted", "fused")  # every snapshot is held against sorted's


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.spacesaving import (EMPTY, Summary, bounded_estimates,
                                              chunk_histogram)
    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.engine import EngineConfig, SketchEngine, SketchState
    from repro_torch.eval.accuracy import check_record, exact_oracle, run_cell
    from repro_torch.kernels import build, ops, ref, ss_combine, ss_ingest, ss_match, ss_query
    from repro_torch.launch import tune
    from repro_torch.plan import PLAN_OPS, ExecutionPlan, planned_engine_config, use_plan
    from repro_torch.plan.probe import _probe_inputs
    from repro_torch.service import QueryFrontend

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # -- phase 1: device and build -------------------------------------------
    card = card_line()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in libs}
    emit({"phase": "build", "card": card, "kind": kind, "build_s": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas": ptxas})

    # -- phase 2: kernels against their plain versions -----------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    window = DEPTH * CHUNK

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def zero_counts():
        ss_combine.LAUNCHES = ss_combine.DENSE_LAUNCHES = 0
        ss_query.LAUNCHES = ss_match.LAUNCHES = 0
        ss_ingest.INGEST_LAUNCHES = ss_ingest.COMBINE_LAUNCHES = 0

    def read_counts():
        """Launches per kernel row; ``ss_combine_match_dense`` is the part of
        ``ss_combine_match`` that took the dense kernel."""
        return {"ss_combine_match": ss_combine.LAUNCHES, "ss_query": ss_query.LAUNCHES,
                "ss_match": ss_match.LAUNCHES,
                "ss_fused_ingest": ss_ingest.INGEST_LAUNCHES,
                "ss_fused_combine": ss_ingest.COMBINE_LAUNCHES,
                "ss_combine_match_dense": ss_combine.DENSE_LAUNCHES}

    # realistic main-path inputs: summaries after one window of a zipf(1.1)
    # stream per tenant, and the exact histogram of the next window
    ids = zipf_stream(TENANTS * 2 * window, 1.1, seed=1, max_id=MAX_ID)
    ids = on_card(ids.reshape(TENANTS, 2 * window))
    s0 = Summary(torch.full((TENANTS, K), EMPTY, dtype=torch.int32, device=dev),
                 torch.zeros((TENANTS, K), dtype=torch.int32, device=dev),
                 torch.zeros((TENANTS, K), dtype=torch.int32, device=dev))
    summ = Summary(*ops.ingest_window(*s0, ids[:, :window], impl="sorted"))
    h_items, h_weights = chunk_histogram(ids[:, window:])

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def profiled(fn, reps):
        """Device time per call of each CUDA kernel (µs) under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0.0)
            if total > 0:
                out[ev.key] = (total, ev.count)
        return out

    def device_ms(fn, reps, kernel):
        """Device time of one launch of ``kernel`` (by name), or None if unseen."""
        hits = [(t, n) for key, (t, n) in profiled(fn, reps).items() if kernel in key]
        if not hits:
            return None
        return sum(t for t, _ in hits) / sum(n for _, n in hits) / 1e3

    def sliced(fn, args, rows):
        """The plain version over the batch in slices of ``rows`` entries."""
        outs = [fn(*(None if a is None else a[i:i + rows] for a in args))
                for i in range(0, args[0].shape[0], rows)]
        return tuple(None if o[0] is None else torch.cat(o) for o in zip(*outs))

    def compare(got, want):
        diff = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                raise AssertionError("kernel and plain version differ in outputs")
            if g is None:
                continue
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"kernel {g.dtype}{tuple(g.shape)} vs plain "
                                     f"{w.dtype}{tuple(w.shape)}")
            diff = max(diff, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
            if not torch.equal(g, w):
                raise AssertionError("kernel output is not bitwise equal to the plain version")
        return diff

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def bound(bytes_moved, ops_needed):
        """The least time for the work: bytes over the memory rate, or the
        operations over the scalar peak, whichever is longer."""
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops_needed / SCALAR_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def valid(t):
        return int((t != EMPTY).sum())

    # Both functions are equi-joins: a hash join does one insert per valid
    # summary id and one probe per valid candidate (or query), so that is
    # the operation count of the bound. The dense kernels' own work, one
    # compare per (valid row, column) pair, is reported beside it as
    # dense_compare_ms and is not a bound of the function.

    def combine_case(label, s_items, c_items, c_counts, c_errors, rows, reps,
                     kernel=None):
        """``kernel`` None takes the wrapper's rule (the hash join where its
        table fits); ``'dense'`` times the dense kernel at the same shape."""
        args = (s_items, c_items, c_counts, c_errors)
        ran = kernel or ss_combine.kernel_for(s_items.shape[0], s_items.shape[-1],
                                              c_items.shape[-1], c_counts.dtype,
                                              c_errors is not None)

        def launch():
            return ss_combine._combine_match(*args, kernel)

        got = launch()
        torch.cuda.synchronize()
        want = sliced(ref.combine_match_ref, args, rows)
        err = compare(got, want)
        ms = time_ms(launch, reps)
        dev_ms = device_ms(launch, reps, f"combine_{ran}_kernel")
        plain_ms = time_ms(lambda: sliced(ref.combine_match_ref, args, rows), 2)
        b_ms, b_by = bound(nbytes(*args, *got[:3]) + got[3].numel(),
                           valid(s_items) + valid(c_items))
        dense_ms = valid(s_items) * c_items.shape[-1] / SCALAR_OPS_PER_S * 1e3
        return {"case": label, "shape": {"B": s_items.shape[0], "k": s_items.shape[-1],
                                         "c": c_items.shape[-1]},
                "dtype": str(c_counts.dtype), "errors": c_errors is not None,
                "kernel": ran, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "dense_compare_ms": dense_ms}

    half = TENANTS // 2
    pair = [a.reshape(half, 2, K) for a in summ]
    s1 = Summary(*(a[:, 0].contiguous() for a in pair))
    s2 = Summary(*(a[:, 1].contiguous() for a in pair))
    dup_items = on_card(rng.integers(-1, 4096, (8, window)).astype(np.int32))
    dup_counts = on_card(rng.integers(0, 1000, (8, window)).astype(np.int32))
    wide = 1 << 33
    # the flush of an engine on the H100 plan's own geometry (chunk 8192,
    # depth 8): the histogram of a W 65 536 zipf window per tenant
    planned_w = 8 * 8192
    planned_ids = on_card(zipf_stream(TENANTS * planned_w, 1.1, seed=4, max_id=MAX_ID)
                          .reshape(TENANTS, planned_w))
    ph_items, ph_weights = chunk_histogram(planned_ids)
    del planned_ids
    many = 65537                                      # above grid.y's 65 535
    many_s, many_c = (on_card(rng.integers(-1, 24, (many, 16)).astype(np.int32))
                      for _ in range(2))
    many_counts = on_card(rng.integers(0, 1000, (many, 16)).astype(np.int32))
    combine_cases = [
        combine_case("flush", summ.items, h_items, h_weights, None, 4, 20),
        combine_case("combine", s1.items, s2.items, s2.counts, s2.errors, 8, 50),
        combine_case("planned", summ.items, ph_items, ph_weights, None, 1, 20),
        combine_case("duplicates", summ.items[:8].contiguous(), dup_items,
                     dup_counts, dup_counts, 4, 20),
        combine_case("int64", s1.items, s2.items, s2.counts.long() + wide,
                     s2.errors.long() + wide, 8, 50),
        combine_case("batch_65537", many_s, many_c, many_counts, many_counts // 3,
                     many, 20),
        # the dense kernel, kept for k above the hash table's limit, at the
        # same shapes: one run gives the time before and after the hash join
        combine_case("flush_dense", summ.items, h_items, h_weights, None, 4, 20,
                     kernel="dense"),
        combine_case("combine_dense", s1.items, s2.items, s2.counts, s2.errors, 8, 50,
                     kernel="dense"),
        combine_case("planned_dense", summ.items, ph_items, ph_weights, None, 1, 5,
                     kernel="dense"),
    ]
    emit({"phase": "kernel", "kernel": "ss_combine_match", "cases": combine_cases})

    def rows_of(*arrays):
        return tuple(map(on_card, arrays))

    def query_row(q):
        """Summary row 0 and q queries, half of them ids it monitors: (k,)
        and (q,) tensors, as the frontend sends them."""
        s = Summary(*(a[0] for a in summ))
        monitored = s.items[s.items != EMPTY]
        pick = rng.integers(0, monitored.numel(), q // 2)
        qs = torch.cat([monitored[on_card(pick)],
                        on_card(rng.integers(-1, MAX_ID, q - q // 2).astype(np.int32))])
        return s.items, s.counts, s.errors, qs

    def query_case(label, args, reps, kernel=None):
        """``kernel`` None takes the wrapper's shape rule; a name forces that
        variant at a shape the rule gives another."""
        s = Summary(*args[:3])
        qs = args[3]
        b = s.items.shape[:-1].numel()
        ran = kernel or ss_query.kernel_for(b, s.items.shape[-1], qs.shape[-1],
                                            s.counts.dtype)

        def launch():
            return ss_query._query(*args, kernel)

        got = launch()
        torch.cuda.synchronize()
        want = ref.query_ref(*args)
        err = compare(got, want)
        ms = time_ms(launch, reps)
        dev_ms = device_ms(launch, reps, f"query_{ran}_kernel")
        plain_ms = time_ms(lambda: ref.query_ref(*args), 5)
        b_ms, b_by = bound(nbytes(*args, *got[:2]) + got[2].numel(),
                           valid(s.items) + valid(qs))
        dense_ms = valid(qs) * s.items.shape[-1] / SCALAR_OPS_PER_S * 1e3
        shape = {"k": s.items.shape[-1], "q": qs.shape[-1]}
        if s.items.dim() > 1:
            shape = {"B": s.items.shape[0], **shape}
        return {"case": label, "variant": ran, "forced": kernel is not None,
                "shape": shape, "dtype": str(s.counts.dtype), "max_abs_err": err,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "dense_compare_ms": dense_ms}

    def dup_row(lo, hi, q=256):
        """A k 2048 row of ids < 512 (each about four times, EMPTY among
        them) with counts in [lo, hi), and q queries of ids < 600."""
        items = rng.integers(-1, 512, K).astype(np.int32)
        counts = rng.integers(lo, hi, K).astype(np.int32)
        return (on_card(items), on_card(counts), on_card(counts // 3),
                on_card(rng.integers(-1, 600, q).astype(np.int32)))

    many_q = on_card(rng.integers(-1, 24, (many, 16)).astype(np.int32))
    many_args = (many_s, many_counts, many_counts // 3, many_q)
    bucket = query_row(256)                 # the main path's bucket: B 1, k 2048, q 256
    wide_bucket = (bucket[0], bucket[1].long() + wide, bucket[2].long() + wide, bucket[3])

    def big_rows(big_k, dtype):
        """B 2 rows of ``big_k`` distinct ids and 256 queries a row: above the
        table's limit (k 8193 at int32, k 6144 at int64: several full tiles
        of the dense kernel)."""
        return (on_card(np.stack([rng.permutation(4 * big_k)[:big_k] for _ in range(2)])
                        .astype(np.int32)),
                *rows_of(*(rng.integers(0, 1000, (2, big_k)).astype(dtype)
                           for _ in range(2))),
                on_card(rng.integers(-1, 4 * big_k, (2, 256)).astype(np.int32)))

    # B 2048 rows of k 64: the main summaries cut into 64-slot rows, and 16
    # queries a row, half of them ids of the row
    k64 = [a.reshape(-1, 64) for a in summ]
    k64_items = k64[0].cpu().numpy()
    pick = k64_items[np.arange(len(k64_items))[:, None],
                     rng.integers(0, 64, (len(k64_items), 8))]
    small_rows = (*k64, on_card(np.concatenate(
        [pick, rng.integers(-1, MAX_ID, (len(k64_items), 8))], axis=1).astype(np.int32)))
    row16 = query_row(16)
    query_cases = [
        query_case("main_bucket", bucket, 200),
        query_case("q16", row16, 200),
        query_case("q4096", query_row(4096), 100),
        query_case("batch_65537", many_args, 20),
        query_case("int64", wide_bucket, 200),
        query_case("duplicates", dup_row(0, 2), 200),        # counts of 0 and 1
        query_case("wrap", dup_row(2**30, 2**31 - 1), 200),  # sums wrap at int32
        query_case("k_8193", big_rows(8193, np.int32), 20),
        query_case("k_6144_int64", big_rows(6144, np.int64), 20),
        query_case("k64", small_rows, 50),
        # the dense kernel forced at shapes the rule gives the hash kernel
        query_case("main_bucket_dense", bucket, 100, kernel="dense"),
        query_case("q16_dense", row16, 100, kernel="dense"),
        query_case("batch_65537_dense", many_args, 20, kernel="dense"),
    ]
    variants = {c["variant"] for c in query_cases}
    if variants != set(ss_query.KERNELS):
        raise AssertionError(f"the ss_query cases launched only {sorted(variants)}")
    emit({"phase": "kernel", "kernel": "ss_query", "cases": query_cases})

    # match-weights is an equi-join too: one insert per valid summary id and
    # one probe per valid histogram id. Its path is the tune CLI's update
    # probes (phase 4); the batched case is the flush histogram's shape. It
    # launches ss_combine's kernels, by the same shape rule.

    def match_case(label, s_items, h_items, h_weights, rows, reps):
        args = (s_items, h_items, h_weights)
        ran = ss_combine.kernel_for(s_items.shape[0], s_items.shape[-1],
                                    h_items.shape[-1], h_weights.dtype, False)
        got = ss_match.match_weights(*args)
        torch.cuda.synchronize()
        err = compare(got, sliced(ref.match_weights_ref, args, rows))
        ms = time_ms(lambda: ss_match.match_weights(*args), reps)
        dev_ms = device_ms(lambda: ss_match.match_weights(*args), reps,
                           f"combine_{ran}_kernel")
        plain_ms = time_ms(lambda: sliced(ref.match_weights_ref, args, rows), 3)
        b_ms, b_by = bound(nbytes(*args, got[0]) + got[1].numel(),
                           valid(s_items) + valid(h_items))
        dense_ms = valid(s_items) * h_items.shape[-1] / SCALAR_OPS_PER_S * 1e3
        return {"case": label, "shape": {"B": s_items.shape[0], "k": s_items.shape[-1],
                                         "c": h_items.shape[-1]},
                "dtype": str(h_weights.dtype), "kernel": ran, "max_abs_err": err,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "dense_compare_ms": dense_ms}

    cell = tuple(a[None].contiguous() for a in _probe_inputs("update", K, 4 * K, "int32",
                                                             0, dev))
    jax_s = rows_of(rng.integers(-1, 60, (1, K)).astype(np.int32))[0]
    jax_h, jax_w = rows_of(rng.integers(-1, 60, (1, 4 * K)).astype(np.int32),
                           rng.integers(1, 100, (1, 4 * K)).astype(np.int32))
    wrap_w = rows_of(rng.integers(2**29, 2**31 - 1, (1, 4 * K)).astype(np.int32))[0]
    rag_s, rag_h, rag_w = rows_of(rng.integers(-1, 80, (1, 100)).astype(np.int32),
                                  rng.integers(-1, 80, (1, 57)).astype(np.int32),
                                  rng.integers(1, 100, (1, 57)).astype(np.int32))
    no_h = torch.zeros((1, 0), dtype=torch.int32, device=dev)
    big_s = on_card(np.stack([rng.permutation(4 * 8193)[:8193] for _ in range(2)])
                    .astype(np.int32))
    big_h, big_w = rows_of(rng.integers(-1, 4 * 8193, (2, 5000)).astype(np.int32),
                           rng.integers(1, 100, (2, 5000)).astype(np.int32))
    match_cases = [
        match_case("tune", *cell, 1, 200),
        match_case("batched", summ.items, h_items, h_weights, 4, 20),
        match_case("duplicates", jax_s, jax_h, jax_w, 1, 200),
        match_case("wrap", jax_s, jax_h, wrap_w, 1, 200),
        match_case("int64", cell[0], cell[1], cell[2].long() + wide, 1, 200),
        match_case("ragged", rag_s, rag_h, rag_w, 1, 200),
        match_case("empty", cell[0], no_h, no_h, 1, 200),
        match_case("k_8193", big_s, big_h, big_w, 1, 20),
    ]
    emit({"phase": "kernel", "kernel": "ss_match", "cases": match_cases})

    # The fused kernels compute a whole merge. The operations of their bound
    # are those of a hash join again: one insert per valid summary id and
    # one probe per valid candidate id (window ids, or the other summary's).

    def fused_case(label, fn, plain, args, joined, reps, kernel):
        got = fn(*args)
        torch.cuda.synchronize()
        err = compare(got, plain(*args))
        ms = time_ms(lambda: fn(*args), reps)
        dev_ms = device_ms(lambda: fn(*args), reps, kernel)
        plain_ms = time_ms(lambda: plain(*args), 3)
        b_ms, b_by = bound(nbytes(*args, *got), sum(valid(t) for t in joined))
        shape = {"B": args[0].shape[0], "k": args[0].shape[-1]}
        if len(args) == 4:
            shape["W"] = args[3].shape[-1]
        return {"case": label, "shape": shape, "dtype": str(args[1].dtype),
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}

    def random_summary(b, k, fill, count_hi, id_range):
        """(B, k) summaries: distinct ids in a random ``fill`` share of the slots."""
        items = np.full((b, k), EMPTY, np.int32)
        counts = np.zeros((b, k), np.int32)
        n = int(k * fill)
        for i in range(b):
            slots = rng.permutation(k)[:n]
            items[i, slots] = rng.choice(id_range, n, replace=False)
            counts[i, slots] = rng.integers(1, count_hi, n)
        return Summary(on_card(items), on_card(counts), on_card(counts // 4))

    def widened(s):
        return Summary(s.items, s.counts.long() + wide, s.errors.long() + wide)

    nxt = ids[:, window:].contiguous()
    half_empty = Summary(*(torch.where(torch.arange(K, device=dev) < K // 2, a, z)
                           for a, z in zip(summ, (EMPTY, 0, 0))))
    tie_s = random_summary(8, K, 1.0, 4, 8000)        # counts 1..3
    tie_win = on_card(rng.integers(0, 6000, (8, window)).astype(np.int32))
    small = random_summary(5, 300, 0.6, 1000, 2400)
    small_win = on_card(np.minimum(rng.zipf(1.2, (5, 100)), 2399).astype(np.int32))

    def ingest_case(label, s, win, reps=20):
        return fused_case(label, ss_ingest.fused_ingest, ref.fused_ingest_ref,
                          (*s, win), (s.items, win), reps, "fused_ingest_kernel")

    # the radix sorts' paths: B 8 rows of the flush shape unless named
    rows8 = Summary(*(a[:8].contiguous() for a in summ))
    big_win = rng.integers(-2**31, 2**31, (8, window)).astype(np.int32)
    big_win[:, ::5] = EMPTY
    big_win[:, 1::11] = 2**31 - 1
    big_win[1, :window // 2] = rows8.items[1].cpu().numpy()[rng.integers(0, K, window // 2)]
    vary_win = rng.integers(1 << 24, 1 << 30, (8, window)).astype(np.int32)
    vary_win[rng.random((8, window)) < 0.3] = EMPTY
    equal_win = np.full((8, window), 7, np.int32)
    equal_win[1] = int(rows8.items[1, 3])
    distinct_win = np.stack([rng.permutation(8 * K)[:window] for _ in range(8)])
    def raised(s, offset, dtype):
        """Counts raised above 2^24 or 2^32: ties that differ only in low digits."""
        counts = torch.where(s.items != EMPTY, s.counts.to(dtype) + offset, 0)
        return Summary(s.items, counts, counts // 4)

    base_a, base_b = (random_summary(8, K, fill, 40, 8 * K) for fill in (1.0, 0.7))
    big32, big32_b = (raised(x, 2**24 + 5, torch.int32) for x in (base_a, base_b))
    big64, big64_b = (raised(x, 2**32 + 5, torch.int64) for x in (base_a, base_b))
    ragged_w = 12345

    ingest_cases = [
        ingest_case("flush", summ, nxt),
        ingest_case("int64", widened(summ), nxt),
        ingest_case("empty_window", summ, torch.full_like(nxt, EMPTY)),
        ingest_case("ties", tie_s, tie_win),
        ingest_case("partial", Summary(*(a[:16].contiguous() for a in half_empty)),
                    nxt[:16].contiguous()),
        ingest_case("ragged", small, small_win),
        ingest_case("big_ids", rows8, on_card(big_win)),
        ingest_case("big_ids_int64", widened(rows8), on_card(big_win)),
        ingest_case("high_digits_constant", rows8,
                    on_card(rng.integers(0, 1 << 16, (8, window)).astype(np.int32))),
        ingest_case("all_digits_vary", rows8, on_card(vary_win)),
        ingest_case("w_not_pow2", rows8, nxt[:8, :ragged_w].contiguous()),
        ingest_case("all_equal", rows8, on_card(equal_win)),
        ingest_case("all_distinct", rows8, on_card(distinct_win.astype(np.int32))),
        ingest_case("big_counts", big32, nxt[:8].contiguous()),
        ingest_case("big_counts_int64", big64, nxt[:8].contiguous()),
    ]
    emit({"phase": "kernel", "kernel": "ss_fused_ingest", "cases": ingest_cases})

    def combine_round_case(label, a, b, reps=50):
        return fused_case(label, ss_ingest.fused_combine, ref.fused_combine_ref,
                          (*a, *b), (a.items, b.items), reps, "fused_combine_kernel")

    tie_pairs = [random_summary(8, K, fill, 4, 4000) for fill in (1.0, 0.8)]
    small2 = random_summary(5, 300, 1.0, 1000, 600)
    fused_combine_cases = [
        combine_round_case("combine", s1, s2),
        combine_round_case("int64", widened(s1), widened(s2)),
        combine_round_case("ties", *tie_pairs),
        combine_round_case("partial", s1,
                           Summary(*(a[:half].contiguous() for a in half_empty))),
        combine_round_case("ragged", small2, random_summary(5, 300, 0.3, 1000, 600)),
        combine_round_case("big_counts", big32, big32_b),
        combine_round_case("big_counts_int64", big64, big64_b),
    ]
    emit({"phase": "kernel", "kernel": "ss_fused_combine", "cases": fused_combine_cases,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 3: the main path at real size ---------------------------------
    t_phase = time.perf_counter()
    zero_counts()
    cells, streams, sorted_snaps, rates = [], {}, {}, {}

    def main_cell(skew, impl):
        return run_cell(n=N_MAIN, skew=skew, k=K, impl=impl, tenants=TENANTS,
                        buffer_depth=DEPTH, chunk=CHUNK, max_id=MAX_ID, device="cuda",
                        stream=streams[skew][0], oracle=streams[skew][1])

    def same_as_sorted(skew, impl, snap):
        for a, b in zip(snap.summary, sorted_snaps[skew].summary):
            if not torch.equal(a, b):
                raise AssertionError(f"skew {skew}: {impl} snapshot != sorted snapshot")
        if int(snap.n) != N_MAIN:
            raise AssertionError(f"skew {skew}: {impl} n {int(snap.n)} != {N_MAIN}")

    for skew in SKEWS:
        t_gen = time.perf_counter()
        stream = zipf_stream(N_MAIN, skew, seed=0, max_id=MAX_ID)
        streams[skew] = (stream, exact_oracle(stream, K))
        gen_s = time.perf_counter() - t_gen
        runs = {impl: main_cell(skew, impl) for impl in IMPLS}
        cells += [runs[impl][0] for impl in IMPLS]
        sorted_snaps[skew] = runs["sorted"][1]
        for impl in IMPLS:
            same_as_sorted(skew, impl, runs[impl][1])
        rates[skew] = {i: N_MAIN / runs[i][0]["ingest_s"] for i in runs}
        emit({"phase": "main", "skew": skew, "stream_and_oracle_s": gen_s,
              "cells": [runs[i][0] for i in IMPLS],
              "ingest_items_per_s": rates[skew], "snapshots_identical": True})
    launches = read_counts()
    failures = check_record({"cells": cells})
    if failures:
        raise AssertionError("; ".join(failures))
    for name, count in launches.items():
        if count <= 0 and name not in ("ss_match", "ss_combine_match_dense"):
            raise AssertionError(f"kernel {name} was not launched by the main path")
    if launches["ss_combine_match_dense"]:
        raise AssertionError("the main path's combine-match took the dense kernel")

    # flush, snapshot and query latency at the main shape, after a counted run
    def latency(impl, chunk=CHUNK, depth=DEPTH, prefill=4):
        """Flush, snapshot and query latency after ``prefill`` windows."""
        engine = SketchEngine(EngineConfig(k=K, tenants=TENANTS, chunk=chunk,
                                           buffer_depth=depth, kernel=impl))
        w = chunk * depth
        blocks = on_card(zipf_stream(TENANTS * (prefill + 1) * w, 1.1, seed=2,
                                     max_id=MAX_ID).reshape(TENANTS, -1))
        state = engine.ingest(engine.init(), blocks[:, :prefill * w])
        nxt = blocks[:, prefill * w:].reshape(TENANTS, depth, chunk)
        reps, flush_ms = 10, 0.0
        for _ in range(reps):
            state.buffer.copy_(nxt)
            full = SketchState(state.summary, state.buffer, depth, state.n)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine.flush(full)
            end.record()
            torch.cuda.synchronize()
            flush_ms += start.elapsed_time(end) / reps

        def refill_and_flush():
            state.buffer.copy_(nxt)
            engine.flush(SketchState(state.summary, state.buffer, depth, state.n))

        per_op = profiled(refill_and_flush, reps)
        busy_ms = sum(t for t, _ in per_op.values()) / reps / 1e3
        top_ops = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:8]
        breakdown = [{"op": key[:90], "ms_per_flush": t / reps / 1e3,
                      "calls_per_flush": n / reps} for key, (t, n) in top_ops]
        snap_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = engine.snapshot(state)
            torch.cuda.synchronize()
            snap_ms.append((time.perf_counter() - t0) * 1e3)
        snaps[impl] = snap
        frontend = QueryFrontend(impl)
        query_us = {}
        for q in (16, 4096):
            qs = rng.integers(1, 1000, q).astype(np.int32)
            frontend.estimate(snap, qs)
            samples = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f_hat, _, _ = frontend.estimate(snap, qs)
                f_hat.cpu()
                samples.append((time.perf_counter() - t0) * 1e6)
            query_us[f"q{q}"] = float(np.median(samples))
        return {"flush_ms": flush_ms, "flush_device_busy_ms": busy_ms,
                "flush_breakdown": breakdown,
                "snapshot_ms": float(np.median(snap_ms)), "query_us": query_us}

    snaps = {}
    timing = {impl: latency(impl) for impl in IMPLS}
    emit({"phase": "main", "launches": launches, "latency": timing,
          "seconds": time.perf_counter() - t_phase})

    def query_split(snap, q, reps=50):
        """Where one ``QueryFrontend.estimate`` under ``cuda`` spends its
        time: the host clock around the whole call with its copy back, the
        device time of everything it runs (profiler), and the host clock of
        each of its public steps alone (medians of ``reps``)."""
        frontend = QueryFrontend("cuda")
        s = Summary(*(a.contiguous() for a in snap.summary))
        qs = rng.integers(1, 1000, q).astype(np.int32)

        def host_ms(fn):
            fn()
            samples = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return float(np.median(samples))

        def whole():
            f_hat, _, _ = frontend.estimate(snap, qs)
            return f_hat.cpu()

        padded, _ = frontend.plan(qs, device=dev)
        kernel = ss_query.kernel_for(1, s.items.shape[-1], padded.shape[-1],
                                     s.counts.dtype)
        f, e, m = ss_query.query(*s, padded)
        f_hat = bounded_estimates(s, f, e, m)[0]
        steps = {
            "frontend_padding": host_ms(lambda: frontend.plan(qs, device=dev)),
            "ops_query": host_ms(lambda: ops.query(*s, padded, impl="cuda")),
            "wrapper": host_ms(lambda: ss_query.query(*s, padded)),
            "bounded_estimates": host_ms(lambda: bounded_estimates(s, f, e, m)),
            "copy_back": host_ms(lambda: f_hat[:q].cpu()),
        }
        per_op = profiled(whole, reps)
        kernel_ms = sum(t for key, (t, _) in per_op.items()
                        if f"query_{kernel}_kernel" in key) / reps / 1e3
        return {"q": q, "bucket": padded.shape[-1], "variant": kernel,
                "host_ms": host_ms(whole),
                "device_busy_ms": sum(t for t, _ in per_op.values()) / reps / 1e3,
                "kernel_device_ms": kernel_ms,
                "device_ops": {key[:60]: {"ms": t / reps / 1e3, "calls": n / reps}
                               for key, (t, n) in per_op.items()},
                "host_steps_ms": steps}

    emit({"phase": "query_split", "impl": "cuda", "card": card,
          "splits": [query_split(snaps["cuda"], q) for q in (16, 4096)]})

    # -- phase 4: the tune CLI measures a plan on the card -------------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tune-") as tmp:
        out = Path(tmp) / "plan_record.json"
        argv = ["--check", "--no-reductions", "--ops", "update,combine,query,flush",
                "--kernels", "torch,sorted,cuda", "--k", "256,1024,2048",
                "--chunks", "512,2048,8192", "--cache-dir", str(Path(tmp) / "plans"),
                "--out", str(out)]
        log = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(log):
            rc = tune.main(argv)
        tune_launches = read_counts()
        if rc != 0:
            print(log.getvalue(), file=sys.stderr)
            raise AssertionError(f"tune --check exited {rc}")
        record = json.loads(out.read_text())
    plan = ExecutionPlan.from_json(record["plan"])
    if not plan.fingerprint.startswith("cuda-") or plan.source != "measured":
        raise AssertionError(f"tune made no measured card plan: {record['plan']}")
    if tune_launches["ss_match"] <= 0:
        raise AssertionError("kernel ss_match was not launched by the tune CLI")
    gates = [{"op": g["op"], "k": g["k"], "c": g["c"], "planned": g["planned"],
              "static": g["static_impl"], "margin": g["margin"],
              "fresh_ms": {i: t * 1e3 for i, t in g["fresh_s"].items()}}
             for g in record["check"]["tolerance_cells"]]
    emit({"phase": "tune", "argv": argv, "fingerprint": plan.fingerprint,
          "kernels": record["plan"]["kernels"], "chunk": plan.chunk,
          "query_min_batch": plan.query_min_batch,
          "model_max_rel_err": record["model_max_rel_err"],
          "held_out_cells": len(record["validation"]),
          "tolerance": record["config"]["tolerance"], "gates": gates,
          "bitwise_equivalent": all(record["check"]["bitwise_equivalent"].values()),
          "plan_resolution": record["plan_resolution"], "launches": tune_launches,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 5: the main path with kernel="auto" under the measured plan ----
    t_phase = time.perf_counter()
    zero_counts()
    auto_cells = []
    with use_plan(plan):
        cfg = EngineConfig(k=K, tenants=TENANTS, chunk=CHUNK, buffer_depth=DEPTH)
        taken = {op: plan.impl_for(op, K) for op in PLAN_OPS}
        engine_taken = {"combine": cfg.resolved_kernel(),
                        "flush": cfg.resolved_flush_kernel()}
        for skew in SKEWS:
            cell, snap = main_cell(skew, "auto")
            same_as_sorted(skew, "auto", snap)
            auto_cells.append(cell)
            rates[skew]["auto"] = N_MAIN / cell["ingest_s"]
        auto_launches = read_counts()
        timing["auto"] = latency("auto")
    failures = check_record({"cells": auto_cells})
    if failures:
        raise AssertionError("; ".join(failures))
    emit({"phase": "main_auto", "impl_taken_at_k": K, "impl_taken": taken,
          "engine": engine_taken, "cells": auto_cells, "ingest_items_per_s": rates,
          "launches": auto_launches, "snapshots_identical": True,
          "latency": timing["auto"], "seconds": time.perf_counter() - t_phase})

    # the plan's own geometry (its chunk and buffer depth) for a few windows
    # per tenant, held against a sorted engine of the same geometry; 'auto'
    # takes the fused kernels there only where their shapes fit
    t_phase = time.perf_counter()
    with use_plan(plan):
        planned = planned_engine_config(K, tenants=TENANTS)
        w_planned = planned.chunk * planned.buffer_depth
        flush_impl, fused_tree = planned.resolved_flush_kernel(), planned.pair_fn() is not None
        blocks = on_card(zipf_stream(TENANTS * (7 * w_planned // 2), 1.1, seed=3,
                                     max_id=MAX_ID).reshape(TENANTS, -1))
        zero_counts()
        engine = SketchEngine(planned)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        planned_snap = engine.snapshot(engine.ingest(engine.init(), blocks))
        torch.cuda.synchronize()
        planned_s = time.perf_counter() - t0
        planned_launches = read_counts()
        planned_latency = latency("auto", planned.chunk, planned.buffer_depth, prefill=1)
    if flush_impl == "fused" and not ss_ingest.fits(K, w_planned):
        raise AssertionError(f"auto routed a flush of W {w_planned} to the fused kernel")
    if flush_impl == "cuda" and (planned_launches["ss_combine_match"] <= 0
                                 or planned_launches["ss_combine_match_dense"]):
        raise AssertionError("the planned engine's flushes did not take the hash join")
    sorted_engine = SketchEngine(dataclasses.replace(planned, kernel="sorted"))
    sorted_snap = sorted_engine.snapshot(sorted_engine.ingest(sorted_engine.init(), blocks))
    for a, b in zip(planned_snap.summary, sorted_snap.summary):
        if not torch.equal(a, b):
            raise AssertionError("planned-geometry snapshot != sorted snapshot")
    if int(planned_snap.n) != blocks.numel():
        raise AssertionError(f"planned engine n {int(planned_snap.n)} != {blocks.numel()}")
    emit({"phase": "main_planned", "k": K, "tenants": TENANTS, "chunk": planned.chunk,
          "buffer_depth": planned.buffer_depth, "window": w_planned,
          "flush_impl": flush_impl, "fused_tree": fused_tree, "ids": blocks.numel(),
          "ingest_and_snapshot_items_per_s": blocks.numel() / planned_s,
          "launches": planned_launches, "snapshots_identical": True,
          "latency": planned_latency, "seconds": time.perf_counter() - t_phase})

    # -- the contract lines ---------------------------------------------------
    def row(name, source, replaces, cases, path="main"):
        head = cases[0]
        extra = {key: head[key] for key in ("dense_compare_ms",) if key in head}
        counts = tune_launches if path == "tune" else launches
        count = counts[name]
        if name == "ss_combine_match":
            extra["dense_launches"] = counts["ss_combine_match_dense"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count, "launches_path": path,
                "max_abs_err": max(c["max_abs_err"] for c in cases), "tolerance": 0,
                "ms": head["ms"], "device_ms": head["device_ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], **extra,
                "library_ms": None,
                "library_note": "no single PyTorch call computes this function",
                "shape": head["shape"], "cases": cases}

    emit({"kernels": [
        row("ss_combine_match", "src/repro_torch/csrc/ss_combine.cu",
            "src/repro/kernels/ss_combine.py:64", combine_cases),
        row("ss_query", "src/repro_torch/csrc/ss_query.cu",
            "src/repro/kernels/ss_query.py:56", query_cases),
        row("ss_match", "src/repro_torch/csrc/ss_combine.cu",
            "src/repro/kernels/ss_match.py:57", match_cases, path="tune"),
        row("ss_fused_ingest", "src/repro_torch/csrc/ss_ingest.cu",
            "src/repro/kernels/ss_ingest.py:69", ingest_cases),
        row("ss_fused_combine", "src/repro_torch/csrc/ss_ingest.cu",
            "src/repro/kernels/ss_ingest.py:113", fused_combine_cases),
    ], "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
