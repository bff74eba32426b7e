#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Thirteen phases and a checkpoint line, each printing one JSON line or more:

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
   flush; torch, sorted, cuda and fused), the serving tier's write path at
   its width (64 lanes: the publish and pipeline probes) and the reduction
   strategies at p = 1 (one card: the plan keeps no reduction table),
   writes a plan under a temporary directory and must pass its tolerance
   and bitwise gates; the plan's tables, chunk, query bucket floor, gate
   margins, the probe rows and the serving knobs they chose
   (``publish_every``, ``ring_depth``, ``coalesce_max``, ``feed_depth``,
   ``lazy_publish``) are printed;
5. the main path of phase 3 again with ``kernel="auto"`` under that plan:
   snapshots identical to ``sorted``'s, the guarantees held, the impl
   ``auto`` took for each op, its ingest rate beside the fixed impls' and
   its flush, snapshot and query latency; then an engine on the plan's own
   geometry (``planned_engine_config``: its chunk and buffer depth) for a
   few windows, its resolved flush impl, its snapshot held against a
   ``sorted`` engine's of the same geometry, and its flush, snapshot and
   query latency;
6. the runtime: ``StreamRuntime(shards=1)`` at the main path's width (64
   lanes, k 2048, C 2048, T 8) over phase 3's skew-1.1 stream cut into 16
   host blocks of 2^22 ids, under ``auto`` (the measured plan) and
   ``cuda``: ``feed`` at depths 1, 2 and the plan's (pinned staging on a
   side stream) and ``ingest`` of the same blocks staged beforehand, every
   snapshot identical to a ``sorted`` runtime's fed the same blocks and
   the guarantees held against phase 3's oracle; items/s of each, the
   host-to-device time of one block (pinned and pageable), the counters
   ``runtime.feed.blocks`` (16 a feed), ``engine.flush_calls`` and
   ``runtime.snapshot_publishes``, ``runtime.feed.step_s`` p50/p99, a
   trace span around the phase and one seen in a short profiler window;
   and the one-shot ``frequent_items`` at p 64 against the engine's
   ``prune`` of the same decomposition;
- the checkpoint line: phase 3's skew-1.1 ``auto`` state saved mid-window
   (fill 3) into a temporary directory, restored onto the card and run to
   the end of the stream, bitwise the run that never stopped; then
   ``reshard_token_sketch`` from 64 groups to 16 under ``cuda`` and
   ``fused``, each bitwise ``sorted``'s; save and restore ms;
7. the serving tier: first a reader-ordering check under ``auto`` and
   ``cuda`` (every publish of the ingest loop held back behind a sleep on
   its stream, in tensors that hold -7 until then; the drained snapshot
   read at once from another stream must hold the synchronous run's
   bits), then ``launch/bench_serve.run_bench`` at the main width over
   phase 3's skew-1.1 stream in 64 host blocks of 2^20 ids (one full
   buffer a block), ``auto`` (the measured plan) and ``cuda`` against
   ``sorted``, 4 readers at 50 qps, k-majority 64, at the knobs of the
   static plan pinned (a publish every 8 blocks, ring 4, coalesce 1, feed
   depth 2, eager): the baseline and loaded snapshots bitwise the
   synchronous reference
   and ``sorted``'s, lazy publishes equal to eager ones, the pipeline arms
   equal, admission accounting closed, the health gauges equal to
   ``oracle_free_invariants``, valid flight records, the guarantees
   against phase 3's oracle, and every main-path kernel launched; the
   rates, ``ingest_ratio``, read p50/p99, publishes, lazy
   materializations, the pipeline gain, the sentinel threads' host copies
   and the JAX ``--check`` verdict of the timing gates are printed; then
   one more ``auto`` run under the knobs phase 4 measured (whose cadence
   may exceed the 64 blocks), its snapshots bitwise the pinned arm's, its
   rates, read p50/p99 and publishes printed beside the pinned arm's;
8. the obs gates: ``launch/bench_obs.run_bench`` at the main width (64
   lanes, k 2048, C 2048, T 8, 64 blocks of 2^20 ids, 2 reps, ``auto``
   under the measured plan): the health gauges bitwise
   ``oracle_free_invariants``, the drift CIs covering s = 1.1, 1.5 and 2.0,
   one valid flight record of a ``RuntimeError`` with at least one frame;
   the on/off rates, the overhead ratio and the JAX gate's verdict at 0.97
   printed, not enforced; then ``launch/metrics`` at the main width in
   JSON and in Prometheus text: the tier's and the process's counters
   nonzero and every exposition line parsed;
9. the paper's scaling sweep: ``launch/scale.run_sweep`` at p = 1 (more
   needs more cards) over phase 3's skew-1.1 stream at the main geometry,
   strong and weak, every strategy, ``cuda`` and ``auto``: every strong
   cell bitwise one engine over the same tenants; items/s, ingest and
   reduce times printed;
10. the LM serving path: ``launch/serve.run_serve`` on qwen2.5-14b at full
   width (bf16, 48 layers, d 5120, 40/8 heads, d_ff 13 824, vocab 152 064,
   QKV bias) with fresh weights from a seeded ``torch.Generator`` on the
   card, B 4, a 64-token prompt, 32 greedy decode steps and a hot-token
   report every 16, once with the token sketch under ``auto`` (the measured
   plan) and once under ``cuda``: each arm's sketch bitwise a ``sorted``
   engine fed the same tokens in the same chunks, the guarantees held
   against exact counts, and at least one ``ss_*`` launch; prefill ms and
   decode ms a step (CUDA events, after one warm-up step) beside the
   step's bound (the bytes it must read over the memory rate), tokens/s,
   peak memory and the host ms of each step's sketch update; the decode
   step against the forward over the same 72 tokens (8 teacher-forced
   steps after the prompt, within ``LM_TOL_STEPS`` of the largest logit),
   one decode step under the profiler; and a smoke arch served on the card
   and on the CPU with the same f32 weights (logits within 1e-4, the same
   tokens, the sketch bitwise);
11. the LM training path: a) ``launch/train.run_train`` on qwen2.5-14b at
   full width but 4 of its 48 layers (bf16, d 5120, 40/8 heads, d_ff
   13 824, vocab 152 064, QKV bias, full remat; all 48 would need 236 GB of
   weights, grads, master weights and moments), fresh seeded weights on
   the card, TokenStream batches of B 4 × S 512, 16 steps of
   ``cosine_schedule(3e-4, 20, 16)``, a sketch merge every 8, the token
   sketch under ``auto`` (the measured plan), no checkpoint: every loss and
   grad norm finite, ``opt.count`` 16, every bf16 param bitwise its master
   weight, the mean loss of steps 13–16 below step 1's, the sketch bitwise
   a ``sorted`` and a ``cuda`` engine fed the same batches in the same
   chunks, the guarantees against exact counts, ``ss_fused_ingest``
   launched by the trainer and ``ss_combine_match`` by the ``cuda``
   engine; step ms (CUDA events) and its split (forward + backward, clip +
   AdamW, the sketch's host ms), tokens/s, the FLOP and byte bounds, peak
   memory, and one step under the profiler; b) the smoke arch trained 4
   steps on the card and on the CPU from the same f32 weights (losses within
   1e-4 and grad norms within 1e-3 relative, params within 4·Σlr + 1e-5,
   the batches and the sketch bitwise); c) ``launch/train.main`` at the
   smoke arch on the card with ``--crash-at 4``, then resumed to step 8:
   ``[resume] restored step 4``, the batches and the sketch bitwise those
   of an uninterrupted run, its losses of steps 5–8 within
   ``LM_RESUME_RTOL``;
12. the MLA family: a) phase 10's checks and numbers on minicpm3-4b whole
   (bf16, 62 layers, d 2560, 40 heads, q_lora 768, kv_lora 256, nope 64,
   rope 32, v 64, d_ff 6 400, vocab 73 448; 4.26·10^9 parameters): the
   decode step scores against the latent cache in the absorbed form, the
   forward expands it; plus the latent cache's bytes a token against a
   GQA cache of the same heads; b) phase 11a's checks and numbers at its
   widths cut to 32 of 62 layers, and 11b on its smoke arch;
13. the MoE family: a) phase 10's checks and numbers on qwen3-moe-30b-a3b
   whole (bf16, 48 layers, d 2048, 32/4 heads of 128, 128 experts, top-8,
   d_ff_expert 768, renormalized top-k, vocab 151 936; 3.05·10^10
   parameters), decode against the forward printed, not checked (the
   forward drops beyond capacity where a decode step cannot, and the
   router's bf16 logits of a 288-row and a 4-row product round apart);
   every checked decode step routes B·8·48 assignments; two byte bounds
   of a decode step (the routed experts only, and every expert as the
   capacity dispatch reads them); the smoke arch's decode steps route
   alike on the card and the CPU, and on each match a forward at capacity
   factor E/k (no drops) within 5e-4 at f32; e) one MoE layer at full width, f32, capacity factor 8, against a
   dense reference (every token through its top-k experts) within 1e-4;
   b) phase 11a's checks and numbers cut to 4 of 48 layers, plus finite
   MoE aux losses, the router's counts summing to 2 048·8·4 a step, the
   expert sketch bitwise a ``sorted`` expert engine fed the same counts,
   and ``ss_combine_match`` launched by it every step; 11b at lr 1e-6 with
   the expert sketches bitwise too; c) 11c on mixtral-8x7b's smoke arch
   (MoE with a sliding window), the expert sketch bitwise too.

Each path (3, 4, 5, the planned engine, 6, the checkpoint line, 7 and its
measured-knob arm, 8, the metrics dump, 9, each arm of 10, 12a and 13a,
the trainers of 11a, 12b and 13b and their ``cuda`` engines) runs with the
kernels' launch counts set to 0 just before it and read just after. Then
the kernel table as one JSON line (each row's ``launches`` from the main
path, ``serve_launches``, ``obs_launches``, ``scale_launches``,
``lm_serve_launches``, ``lm_serve_cuda_launches``, ``lm_train_launches``
and ``lm_train_cuda_launches`` from phases 7's pinned arm, 8, 9, the two
arms of 10 and the two paths of 11a, and the same pairs ``lm_mla_*`` and
``lm_moe_*`` from phases 12 and 13), the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and no result line is printed. Without
a CUDA card, or without the rest of the repository beside it, it exits 1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12     # H100 non-tensor-core float32 peak, used for int32 compares
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
N_MAIN = 1 << 26             # ids in the main-path stream (256 MiB of int32 on the card)
FEED_BLOCKS = 16             # host blocks of the runtime phase (2^22 ids each)
SERVE_BLOCK = 1 << 20        # ids per host block of the serving phase: one full buffer
TENANTS, K, CHUNK, DEPTH = 64, 2048, 2048, 8
SKEWS = (1.1, 1.8)           # the paper's Table I
MAX_ID = 10**6
IMPLS = ("cuda", "sorted", "fused")  # every snapshot is held against sorted's
# phase 10: qwen2.5-14b at full width, B 4, a 64-token prompt, 32 decode
# steps, a report every 16
LM_BATCH, LM_PROMPT, LM_GEN, LM_REPORT_EVERY = 4, 64, 32, 16
# check a)'s tolerance, as a fraction of the largest |logit|: 16 bf16 steps
# (2^-8 relative each) at the top of the logits' range. The forward and the
# decode step round every product and the residual stream to bf16 in 48
# layers, with products of other shapes (M 288 against M 4, so cuBLAS picks
# other reduction orders) and other attention arithmetic (the blockwise
# online softmax against the decode step's analytic merge); a wrong position,
# cache slot or mask moves logits by their own size
LM_TOL_STEPS = 2.0 ** -4
# phase 11: qwen2.5-14b at full width cut to 4 layers (16 B a parameter of
# bf16 params and grads, f32 master weights and moments: 42.5 GB at 4
# layers, 236 GB at 48), B 4 × S 512, 16 steps, a sketch merge every 8
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_MERGE = 4, 4, 512, 16, 8
# phase 12b: minicpm3-4b at its widths cut to 32 of 62 layers: 2.38·10^9
# parameters, 38 GB at 16 B a parameter (all 62 would need 68 GB before
# activations); phase 13b: qwen3-moe-30b-a3b cut to 4 of 48 layers: 3.11·10^9
# parameters, 49.8 GB (all 48 would need 489 GB). B 4 × S 512, 16 steps
LM_MLA_TRAIN_LAYERS, LM_MOE_TRAIN_LAYERS = 32, 4
# 11c's tolerance on the resumed run's losses, relative: the resumed run
# starts from the same f32 tensors and runs the same kernels on the same
# shapes, so 0 is expected; a nondeterministic kernel (an atomic sum) would
# move a loss by a few f32 ulps
LM_RESUME_RTOL = 1e-6


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
    from repro_torch.core.parallel import block_decompose
    from repro_torch.core.spacesaving import prune
    from repro_torch.eval.accuracy import check_record, exact_oracle, run_cell, score_snapshot
    from repro_torch.kernels import build, ops, ref, ss_combine, ss_ingest, ss_match, ss_query
    from repro_torch.launch import tune
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import Tracer
    from repro_torch.plan import PLAN_OPS, ExecutionPlan, planned_engine_config, use_plan
    from repro_torch.plan.probe import _probe_inputs
    from repro_torch.runtime import (RuntimeConfig, StreamRuntime, frequent_items,
                                     host_blocks)
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.launch import bench_obs, bench_serve, scale
    from repro_torch.launch import metrics as metrics_cli
    from repro_torch.obs import health as obs_health
    from repro_torch.serve import ServeConfig, ServingTier
    from repro_torch.service import QueryFrontend
    from repro_torch.service.snapshot import publish
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

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
        argv = ["--check", "--ops", "update,combine,query,flush,publish,pipeline",
                "--kernels", "torch,sorted,cuda", "--k", "256,1024,2048",
                "--chunks", "512,2048,8192", "--lanes", str(TENANTS),
                "--cache-dir", str(Path(tmp) / "plans"), "--out", str(out)]
        log = io.StringIO()
        zero_counts()
        with contextlib.redirect_stdout(log):
            rc = tune.main(argv)
        tune_launches = read_counts()
        if rc != 0:
            print(log.getvalue(), file=sys.stderr)
            failures = (json.loads(out.read_text())["check"]["failures"]
                        if out.exists() else [])
            raise AssertionError(f"tune --check exited {rc}: {failures}")
        record = json.loads(out.read_text())
    plan = ExecutionPlan.from_json(record["plan"])
    if not plan.fingerprint.startswith("cuda-") or plan.source != "measured":
        raise AssertionError(f"tune made no measured card plan: {record['plan']}")
    if tune_launches["ss_match"] <= 0:
        raise AssertionError("kernel ss_match was not launched by the tune CLI")
    # the serving and reduction probes: every row measured, and one card
    # probes p = 1 only, so the plan keeps no reduction table
    serving_rows = record["publish_probes"] + record["pipeline_probes"]
    if (not record["publish_probes"] or {r["knob"] for r in record["pipeline_probes"]}
            != {"coalesce", "feed", "publish"}):
        raise AssertionError("tune ran no publish or pipeline probe")
    if {r["p"] for r in record["reduction_probes"]} != \
            {p for p in (1, 2, 4) if p <= torch.cuda.device_count()}:
        raise AssertionError(f"reduction probes at p {record['reduction_probes']}")
    if torch.cuda.device_count() == 1 and (plan.reductions or plan.pods):
        raise AssertionError("a one-card plan has a reduction table")
    if not all(v > 0 for r in serving_rows + record["reduction_probes"]
               for key, v in r.items() if key.endswith("_s")):
        raise AssertionError("a serving or reduction probe timed nothing")
    knobs = {"publish_every": plan.publish_every, "ring_depth": plan.ring_depth,
             "coalesce_max": plan.coalesce_max, "feed_depth": plan.feed_depth,
             "lazy_publish": plan.lazy_publish}
    if (knobs["publish_every"], knobs["ring_depth"]) != \
            tune._choose_publish(record["publish_probes"]) or \
            (knobs["coalesce_max"], knobs["feed_depth"], knobs["lazy_publish"]) != \
            tune._choose_pipeline(record["pipeline_probes"]):
        raise AssertionError(f"the plan's serving knobs {knobs} are not the choosers'")
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
          "serving_knobs": knobs, "publish_probes": record["publish_probes"],
          "pipeline_probes": record["pipeline_probes"],
          "reduction_probes": record["reduction_probes"], "reductions": plan.reductions,
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

    # -- phase 6: the runtime feeds host blocks through pinned staging -------
    # StreamRuntime(shards=1) at the main path's width over the skew-1.1
    # stream of phase 3, cut into FEED_BLOCKS host (numpy) blocks: feed() at
    # depths 1, 2 and the plan's, against ingest() of the same blocks staged
    # on the card beforehand, under auto (the measured plan) and cuda; every
    # snapshot held against a sorted runtime's fed the same blocks, and the
    # guarantees against phase 3's exact oracle
    t_phase = time.perf_counter()
    stream, (exact, truth) = streams[1.1]
    block_ids = N_MAIN // FEED_BLOCKS
    host = [stream[i:i + block_ids] for i in range(0, N_MAIN, block_ids)]
    reg = obs_metrics.DEFAULT
    names = ("runtime.feed.blocks", "engine.flush_calls", "runtime.snapshot_publishes")
    tracer = Tracer(annotate=True)

    def runtime(kernel, depth=None):
        return StreamRuntime(RuntimeConfig(
            engine=EngineConfig(k=K, tenants=TENANTS, chunk=CHUNK, buffer_depth=DEPTH,
                                kernel=kernel), shards=1, feed_depth=depth))

    def counted(fn):
        """``fn()``'s result, its host seconds after a sync, and the counters it moved."""
        before = {n: reg.counter(n).value for n in names}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return out, seconds, {n: reg.counter(n).value - before[n] for n in names}

    runs, rt_snaps = {}, {}
    zero_counts()
    with tracer.span("chip_smoke.runtime"), use_plan(plan):
        for kernel in ("auto", "cuda"):
            for depth in (1, 2, None):
                rt = runtime(kernel, depth)
                snap, secs, moved = counted(lambda: rt.snapshot(rt.feed(rt.init(), iter(host))))
                if moved["runtime.feed.blocks"] != FEED_BLOCKS:
                    raise AssertionError(f"feed counted {moved['runtime.feed.blocks']} blocks")
                key = f"{kernel}_feed_depth{'_plan' if depth is None else depth}"
                runs[key] = {"feed_depth": rt.config.resolved_feed_depth(),
                             "items_per_s": N_MAIN / secs, "counters": moved}
                rt_snaps[key] = snap
            rt = runtime(kernel)
            staged = [on_card(host_blocks(b, rt.workers, CHUNK)) for b in host]

            def ingest_all():
                state = rt.init()
                for b in staged:
                    state = rt.ingest(state, b)
                return rt.snapshot(state)

            rt_snaps[f"{kernel}_ingest"], secs, moved = counted(ingest_all)
            runs[f"{kernel}_ingest"] = {"items_per_s": N_MAIN / secs, "counters": moved}
            del staged
        rt = runtime("sorted", 2)
        sorted_snap, secs, moved = counted(lambda: rt.snapshot(rt.feed(rt.init(), iter(host))))
        runs["sorted_feed_depth2"] = {"items_per_s": N_MAIN / secs, "counters": moved}
        for key, snap in rt_snaps.items():
            if int(snap.n) != N_MAIN or not all(
                    torch.equal(a, b) for a, b in zip(snap.summary, sorted_snap.summary)):
                raise AssertionError(f"runtime {key}: snapshot != the sorted runtime's")
        rt_cells = []
        for kernel in ("auto", "cuda"):
            snap = rt_snaps[f"{kernel}_feed_depth2"]
            frontend = runtime(kernel).frontend()
            report = frontend.k_majority_report(snap, K)
            rt_cells.append({"skew": 1.1, "k": K, "impl": f"runtime_{kernel}",
                             **score_snapshot(snap, frontend, report, exact, truth, dev)})
        runtime_launches = read_counts()    # the sorted runtime launches none of them
        failures = check_record({"cells": rt_cells})
        if failures:
            raise AssertionError("; ".join(failures))
        for name in ("ss_fused_ingest", "ss_fused_combine", "ss_query", "ss_combine_match"):
            if runtime_launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the runtime phase")

        # a short profiler window: the feed's span must show on its timeline
        from torch.profiler import ProfilerActivity, profile
        rt = runtime("auto")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with tracer.span("runtime.feed"):
                rt.feed(rt.init(), iter(host[:2]))
            torch.cuda.synchronize()
        keys = {ev.key for ev in prof.key_averages()}
        if "runtime.feed" not in keys:
            raise AssertionError("the runtime.feed span is missing from the profiler window")

        # the one-shot API at p = 64 against the engine's prune of the same
        # decomposition (one block of ids, chunk 2048, buffer depth 1)
        one = host[0]
        got = frequent_items(one, k_majority=K, counters=K, p=TENANTS, chunk_size=CHUNK)
        eng = SketchEngine(EngineConfig(k=K, tenants=TENANTS, chunk=CHUNK, buffer_depth=1,
                                        kernel="sorted"))
        merged = eng.merged(eng.ingest(eng.init(), block_decompose(on_card(one), TENANTS, CHUNK)))
        want = prune(merged, one.size, K)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("frequent_items at p 64 != the engine's prune")

    # the copy of one block's rows onto the card, from pinned and from pageable memory
    block = np.ascontiguousarray(host_blocks(host[0], TENANTS, CHUNK))
    pinned = torch.from_numpy(block).pin_memory()
    target = torch.empty(block.shape, dtype=torch.int32, device=dev)
    h2d_ms = {"pinned": time_ms(lambda: target.copy_(pinned, non_blocking=True), 20),
              "pageable": time_ms(lambda: target.copy_(torch.from_numpy(block)), 20)}
    step = reg.histogram("runtime.feed.step_s")
    span = next(e for e in tracer.events() if e["name"] == "chip_smoke.runtime")
    emit({"phase": "runtime", "card": card, "lanes": TENANTS, "k": K, "chunk": CHUNK,
          "buffer_depth": DEPTH, "shards": 1, "blocks": FEED_BLOCKS, "block_ids": block_ids,
          "plan_feed_depth": plan.feed_depth, "runs": runs, "h2d_block_ms": h2d_ms,
          "h2d_block_bytes": block.nbytes, "launches": runtime_launches,
          "feed_step_s": {"count": step.count, "p50": step.percentile(50),
                          "p99": step.percentile(99), "error_bound": step.error_bound},
          "cells": rt_cells, "snapshots_identical": True,
          "trace_span": {"name": span["name"], "dur_s": span["dur_s"]},
          "profiler_window_has_span": True, "frequent_items_p64_equal": True,
          "seconds": time.perf_counter() - t_phase})

    # -- checkpoint: phase 3's skew-1.1 state saved mid-window, restored -------
    # onto the card and run to the end of the stream, against the run that
    # never stopped; then reshard_token_sketch 64 → 16 groups under cuda and
    # fused against sorted, from that mid-window state
    t_phase = time.perf_counter()
    zero_counts()
    ids = block_decompose(on_card(stream), TENANTS, CHUNK)        # (64, 2^20)
    cut = (8 * 32 + 3) * CHUNK                                    # 259 chunks: fill 3
    with use_plan(plan), tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as tmp:
        engine = SketchEngine(EngineConfig(k=K, tenants=TENANTS, chunk=CHUNK,
                                           buffer_depth=DEPTH, kernel="auto"))
        whole = engine.snapshot(engine.ingest(engine.init(), ids))
        mid = engine.ingest(engine.init(), ids[:, :cut])
        if mid.fill != 3:
            raise AssertionError(f"checkpoint state has fill {mid.fill}, not 3")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(tmp, 259, mid, {"cursor": cut})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back, cursor = ckpt.restore(tmp, 259, engine.init())
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        state_bytes = sum(t.numel() * t.element_size()
                          for t in (*back.summary, back.buffer, back.n))
        if back.fill != 3 or back.buffer.device != dev or cursor != {"cursor": cut}:
            raise AssertionError("restored state lost its fill, device or cursor")
        resharded = {}       # from the restored mid-window state (fill 3)
        for impl in ("sorted", "cuda", "fused"):
            cfg = EngineConfig(k=K, tenants=TENANTS, chunk=CHUNK, buffer_depth=DEPTH,
                               kernel=impl)
            resharded[impl] = ckpt.reshard_token_sketch(
                back, 16, match_fn=cfg.match_fn(), window_fn=cfg.window_fn(),
                pair_fn=cfg.pair_fn())
        for impl in ("cuda", "fused"):
            got, want = resharded[impl], resharded["sorted"]
            if not all(torch.equal(a, b) for a, b in
                       zip((*got.summary, got.buffer, got.n),
                           (*want.summary, want.buffer, want.n))):
                raise AssertionError(f"reshard under {impl} != reshard under sorted")
        if int(resharded["cuda"].n.sum()) != cut * TENANTS:
            raise AssertionError("reshard lost items")
        # the engine writes the buffer in place: resume after the reshards
        resumed = engine.snapshot(engine.ingest(back, ids[:, cut:]))
        if int(resumed.n) != N_MAIN or not all(
                torch.equal(a, b) for a, b in zip(resumed.summary, whole.summary)):
            raise AssertionError("restored-and-resumed snapshot != the uninterrupted run's")
    ckpt_launches = read_counts()
    for name in ("ss_fused_ingest", "ss_fused_combine", "ss_combine_match"):
        if ckpt_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the checkpoint line")
    del ids, mid, back, whole, resumed, resharded
    emit({"phase": "checkpoint", "card": card, "state_bytes": state_bytes, "fill": 3,
          "save_ms": save_ms, "restore_ms": restore_ms, "resumed_identical": True,
          "reshard": {"groups": [TENANTS, 16], "impls": ["cuda", "fused"],
                      "identical_to_sorted": True},
          "launches": ckpt_launches, "seconds": time.perf_counter() - t_phase})

    def reader_ordering(kernel):
        """The readers wait for a publish: every publish of the loop is held
        back ~0.1 s behind a sleep on the loop's stream, in tensors that hold
        -7 until then. The drained snapshot, read at once on this thread's
        stream, must hold the synchronous run's bits (and the read waits)."""
        rt = runtime(kernel)
        blocks = [stream[i * SERVE_BLOCK:(i + 1) * SERVE_BLOCK] for i in range(3)]
        state = rt.init()
        for b in blocks:
            state = rt.ingest(state, host_blocks(b, rt.workers, CHUNK))
        want = [t.cpu() for t in rt.snapshot(state).summary]
        plain = rt.snapshot

        def slow(st, **kw):
            snap = plain(st, **kw)
            src = (*snap.summary, snap.n, snap.shard_n)
            out = [torch.full_like(t, -7) for t in src]
            torch.cuda._sleep(200_000_000)
            for o, t in zip(out, src):
                o.copy_(t)
            return publish(Summary(*out[:3]), out[3], out[4], version=snap.version,
                           kernel=snap.kernel)

        rt.snapshot = slow
        with use_plan(plan), tempfile.TemporaryDirectory(prefix="chip-smoke-order-") as tmp:
            cfg = ServeConfig(runtime=rt.config, publish_every=64, ring_depth=4,
                              metrics=False, flight_path=str(Path(tmp) / "flight.json"))
            with ServingTier(cfg, runtime=rt) as tier:
                for b in blocks:
                    tier.submit(b)
                snap = tier.drain()
                t0 = time.perf_counter()
                got = [t.cpu() for t in snap.summary]
                waited_ms = (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{kernel}: a reader read the snapshot before its publish")
        return {"identical": True, "read_waited_ms": waited_ms}

    # -- phase 7: the serving tier under readers ------------------------------
    # launch/bench_serve.run_bench at the main width over phase 3's skew-1.1
    # stream cut into 64 host blocks of 2^20 ids (one full buffer a block),
    # under auto (the measured plan) and cuda, with sorted as the reference
    t_phase = time.perf_counter()
    ordering = {kernel: reader_ordering(kernel) for kernel in ("auto", "cuda")}
    serve_blocks = [stream[i:i + SERVE_BLOCK] for i in range(0, N_MAIN, SERVE_BLOCK)]
    kept = {}
    lines = []
    copies0 = obs_health.HOST_COPIES
    zero_counts()
    serve_kw = dict(k=K, lanes=TENANTS, chunk=CHUNK, depth=DEPTH, blocks=len(serve_blocks),
                    layers=DEPTH, queue_depth=8, admission="block", readers=4, qps=50.0,
                    kmaj=64, pipeline_blocks=len(serve_blocks), device="cuda",
                    host_stream=serve_blocks)
    # the pinned arm runs at the static plan's knobs, so its numbers stay
    # comparable with runs made before the knobs were measured: a publish
    # every 8 blocks, ring 4, coalesce 1, feed depth 2, eager
    with use_plan(plan), tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as tmp:
        serve = bench_serve.run_bench(
            impls=["auto", "cuda"], publish_every=8, ring_depth=4, coalesce_max=1,
            feed_depth=2, lazy_publish=False, pipeline_lazy=True, reference_impl="sorted",
            flight_dir=tmp, keep=lambda impl, phase, snap: kept.__setitem__((impl, phase), snap),
            emit=lambda *a: lines.append(a), **serve_kw)
    serve_launches = read_counts()
    sentinel_copies = obs_health.HOST_COPIES - copies0
    failures = bench_serve.check_record(serve, min_ratio=0.0, p50_slo=float("inf"),
                                        p99_slo=float("inf"))
    if failures:
        raise AssertionError("; ".join(failures))
    # one more auto run under the knobs the tune phase measured; its
    # snapshots must equal the pinned arm's (itself sorted's) bit for bit
    measured_lines, measured_kept = [], {}
    zero_counts()
    with use_plan(plan), tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as tmp:
        measured = bench_serve.run_bench(
            impls=["auto"], publish_every=plan.publish_every, ring_depth=plan.ring_depth,
            coalesce_max=plan.coalesce_max, feed_depth=plan.feed_depth,
            lazy_publish=plan.lazy_publish, flight_dir=tmp,
            keep=lambda impl, phase, snap: measured_kept.__setitem__(phase, snap),
            emit=lambda *a: measured_lines.append(a), **serve_kw)
    measured_launches = read_counts()
    failures = bench_serve.check_record(measured, min_ratio=0.0, p50_slo=float("inf"),
                                        p99_slo=float("inf"))
    for phase, snap in measured_kept.items():
        if not all(torch.equal(a, b) for a, b in
                   zip(snap.summary, kept[("auto", "reference")].summary)):
            failures.append(f"measured-knob arm: {phase} snapshot != the pinned arm's")
    for name in ("ss_query", "ss_fused_ingest", "ss_fused_combine"):
        if measured_launches[name] <= 0:
            failures.append(f"kernel {name} was not launched by the measured-knob arm")
    if failures:
        raise AssertionError("; ".join(failures))
    serve_cells = []
    for impl in ("auto", "cuda"):
        snap = kept[(impl, "loaded")]
        frontend = QueryFrontend(impl)
        report = frontend.k_majority_report(snap, K)
        serve_cells.append({"skew": 1.1, "k": K, "impl": f"serve_{impl}",
                            **score_snapshot(snap, frontend, report, exact, truth, dev)})
    failures = check_record({"cells": serve_cells})
    if failures:
        raise AssertionError("; ".join(failures))
    for name in ("ss_query", "ss_fused_ingest", "ss_fused_combine", "ss_combine_match"):
        if serve_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the serving tier")
    jax_gates = bench_serve.check_record(serve, min_ratio=0.9, p50_slo=0.5, p99_slo=5.0)

    def arm_numbers(r):
        loaded = r["loaded"]
        return {
            "baseline_updates_per_s": r["baseline"]["updates_per_s"],
            "loaded_updates_per_s": loaded["updates_per_s"],
            "ingest_ratio": r["ingest_ratio"],
            "reads": loaded["reads_total"], "achieved_qps": loaded["achieved_qps"],
            "read_s": {op: {k: q[k] for k in ("count", "p50_s", "p99_s",
                                              "bucket_error_bound")}
                       for op, q in loaded["queries"].items()},
            "publishes": {ph: r[ph]["stats"]["publishes"] for ph in ("baseline", "loaded")},
            "lazy": {arm: {k: r["pipeline"][arm].get(k) for k in
                           ("lazy_publish", "publishes_deferred", "publishes_materialized")}
                     for arm in ("legacy", "tuned")},
            "sentinel_host_copies": {ph: r[ph]["pipeline"]["sentinel_host_copies"]
                                     for ph in ("baseline", "loaded")},
            "pipeline_gain": r["pipeline"]["gain"],
            "pipeline_updates_per_s": [r["pipeline"]["legacy_updates_per_s"],
                                       r["pipeline"]["tuned_updates_per_s"]],
        }

    per_impl = {impl: arm_numbers(r) for impl, r in serve["impls"].items()}
    emit({"phase": "serve", "card": card, "lanes": TENANTS, "k": K, "chunk": CHUNK,
          "buffer_depth": DEPTH, "blocks": len(serve_blocks), "block_ids": SERVE_BLOCK,
          "readers": 4, "qps": 50.0, "k_majority": 64,
          "publish_every": 8, "ring_depth": 4, "coalesce_max": 1, "feed_depth": 2,
          "lazy_publish": False, "impls": per_impl,
          "measured_knobs": {"knobs": knobs, "auto": arm_numbers(measured["impls"]["auto"]),
                             "launches": measured_launches,
                             "snapshots_equal_pinned": True,
                             "jax_check_verdict": bench_serve.check_record(
                                 measured, min_ratio=0.9, p50_slo=0.5, p99_slo=5.0) or "ok",
                             "bench_lines": [",".join(map(str, ln))
                                             for ln in measured_lines]},
          "sentinel_host_copies": sentinel_copies, "launches": serve_launches,
          "reader_ordering": ordering, "cells": serve_cells,
          "gates_held": ["reference", "sorted", "lazy_eager", "pipeline_arms",
                         "accounting", "health", "flight_record", "guarantees"],
          "jax_check_verdict": jax_gates or "ok",
          "bench_lines": [",".join(map(str, ln)) for ln in lines],
          "seconds": time.perf_counter() - t_phase})

    # -- phase 8: the obs gates and the metrics dump ---------------------------
    # launch/bench_obs.run_bench at the main width (64 lanes, k 2048, C 2048,
    # T 8; a block is one full buffer, 2^20 ids) over 64 blocks, 2 reps,
    # auto under the measured plan: the health, drift and flight gates are
    # enforced, the overhead ratio and the JAX gate's verdict at 0.97 printed
    t_phase = time.perf_counter()
    obs_lines = []
    zero_counts()
    with use_plan(plan), tempfile.TemporaryDirectory(prefix="chip-smoke-obs-") as tmp:
        obs = bench_obs.run_bench(
            impl="auto", k=K, lanes=TENANTS, chunk=CHUNK, depth=DEPTH, blocks=64,
            layers=DEPTH, publish_every=plan.publish_every, ring_depth=plan.ring_depth,
            queue_depth=8, kmaj=64, reps=2, seed=0, device="cuda",
            flight_path=str(Path(tmp) / "obs_flight.json"),
            emit=lambda *a: obs_lines.append(a))
    obs_launches = read_counts()
    failures = bench_obs.check_record(obs, min_ratio=0.0)
    if [r["s_true"] for r in obs["drift"]] != [1.1, 1.5, 2.0]:
        failures.append(f"drift profiles {[r['s_true'] for r in obs['drift']]}")
    if obs["flight"]["error_type"] != "RuntimeError" or obs["flight"]["frames"] < 1:
        failures.append(f"flight record {obs['flight']}")
    for name in ("ss_fused_ingest", "ss_fused_combine"):
        if obs_launches[name] <= 0:
            failures.append(f"kernel {name} was not launched by the obs bench")
    if failures:
        raise AssertionError("; ".join(failures))

    # the metrics CLI at the main width, in both formats
    dump_argv = ["--device", "cuda", "--k", str(K), "--lanes", str(TENANTS), "--chunk",
                 str(CHUNK), "--depth", str(DEPTH), "--blocks", "8", "--layers", str(DEPTH)]
    dumps = {}
    zero_counts()
    with use_plan(plan), tempfile.TemporaryDirectory(prefix="chip-smoke-metrics-") as tmp:
        for fmt in ("json", "prom"):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = metrics_cli.main([*dump_argv, "--format", fmt, "--events", "4",
                                       "--dump-flight", str(Path(tmp) / f"{fmt}.json")])
            if rc != 0:
                raise AssertionError(f"metrics --format {fmt} exited {rc}")
            dumps[fmt] = log.getvalue().splitlines()
    dump_launches = read_counts()
    events = [ln for ln in dumps["json"] if ln.startswith('{"kind"')]
    dump = json.loads("\n".join(ln for ln in dumps["json"] if ln not in events))
    prom = [ln for ln in dumps["prom"] if not ln.startswith('{"kind"')]
    prom_line = re.compile(
        r"^(# (TYPE|HELP) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
        r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (-?[0-9.]+([eE][-+]?[0-9]+)?|NaN|[-+]Inf))$")
    unparsed = [ln for ln in prom if not prom_line.match(ln)]
    samples = dict(ln.rsplit(" ", 1) for ln in prom if not ln.startswith("#"))
    counters = {
        "tier.blocks_ingested": dump["tier"]["blocks_ingested"],
        "tier.serve.ingest.blocks": dump["tier"]["metrics"]["serve.ingest.blocks"]["value"],
        "tier.serve.read.point_s.count": dump["tier"]["metrics"]["serve.read.point_s"]["count"],
        "process.runtime.snapshot_publishes":
            dump["process"]["runtime.snapshot_publishes"]["value"],
        "process.plan.active_resolutions": dump["process"]["plan.active_resolutions"]["value"],
        "prom.serve_ingest_blocks": float(samples.get("serve_ingest_blocks", 0)),
        "prom.runtime_snapshot_publishes": float(samples.get("runtime_snapshot_publishes", 0)),
    }
    if unparsed or not events or not all(v > 0 for v in counters.values()):
        raise AssertionError(f"metrics dump: unparsed {unparsed[:3]}, events {len(events)}, "
                             f"counters {counters}")
    for name in ("ss_fused_ingest", "ss_fused_combine", "ss_query"):
        if dump_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the metrics dump")
    ov = obs["overhead"]
    emit({"phase": "obs", "card": card, "impl": "auto", "lanes": TENANTS, "k": K,
          "chunk": CHUNK, "buffer_depth": DEPTH, "blocks": 64, "block_ids": SERVE_BLOCK,
          "reps": 2, "publish_every": plan.publish_every, "ring_depth": plan.ring_depth,
          "off_updates_per_s": ov["off_updates_per_s"], "on_updates_per_s": ov["on_updates_per_s"],
          "overhead_ratio": ov["ratio"],
          "jax_check_verdict": bench_obs.check_record(obs, min_ratio=0.97) or "ok",
          "health_consistent": True, "health": obs["health"]["tier"],
          "drift": [{key: r[key] for key in ("s_true", "s_est", "ci_low", "ci_high",
                                             "within_ci", "ranks_used")}
                    for r in obs["drift"]],
          "flight": obs["flight"], "pipeline": {key: v for key, v in obs["pipeline"].items()
                                                if not isinstance(v, dict)},
          "launches": obs_launches, "metrics_dump": {
              "counters": counters, "prom_lines": len(prom), "events": len(events),
              "launches": dump_launches},
          "bench_lines": [",".join(map(str, ln)) for ln in obs_lines],
          "seconds": time.perf_counter() - t_phase})

    # -- phase 9: the paper's scaling sweep at p = 1 ---------------------------
    # launch/scale.run_sweep over phase 3's 2^26-id skew-1.1 stream (the same
    # seed) at the main geometry, strong and weak, under cuda and auto; every
    # strong cell bitwise one engine over the same 64 tenants. p > 1 needs
    # more than one card (nccl at p > 1 has not run)
    t_phase = time.perf_counter()
    scale_lines = []
    zero_counts()
    with use_plan(plan):
        sweep = scale.run_sweep(ps=[1], strategies=list(scale.STRATEGIES),
                                impls=["cuda", "auto"], n=N_MAIN, k=K, lanes=TENANTS,
                                chunk=CHUNK, depth=DEPTH, repeat=2, seed=0, max_id=MAX_ID,
                                device="cuda", emit=lambda *a: scale_lines.append(a))
    scale_launches = read_counts()
    failures = scale.check_record(sweep)
    strong = [c for c in sweep["cells"] if c["mode"] == "strong"]
    if len(strong) != 6 or not all(c["equivalent"] for c in strong):
        failures.append("a strong cell is not the single-process engine's")
    for name in ("ss_combine_match", "ss_fused_ingest", "ss_fused_combine"):
        if scale_launches[name] <= 0:
            failures.append(f"kernel {name} was not launched by the scaling sweep")
    if failures:
        raise AssertionError("; ".join(failures))
    emit({"phase": "scale", "card": card, "p": [1], "lanes": TENANTS, "k": K, "chunk": CHUNK,
          "buffer_depth": DEPTH, "n_strong": N_MAIN,
          "n_weak_per_shard": sweep["config"]["n_weak_per_shard"],
          "cells": [{key: c[key] for key in ("mode", "strategy", "impl", "p", "items_per_s",
                                             "ingest_s", "reduce_s", "equivalent")
                     if key in c} for c in sweep["cells"]],
          "all_equivalent": sweep["summary"]["all_equivalent"], "launches": scale_launches,
          "note": "p > 1 needs more than one card; nccl at p > 1 has not run",
          "seconds": time.perf_counter() - t_phase})

    def sketch_guarantees(cfg, state, tokens):
        """(every f > n/k monitored, lower <= f <= f_hat) of a token sketch's
        merged summary against the exact counts of ``tokens``."""
        sorted_sketch = dataclasses.replace(cfg.sketch, kernel="sorted")
        merged = SK.merge_sketches(SK.token_engine(sorted_sketch, 1, device=dev), state)
        f = np.bincount(tokens.reshape(-1), minlength=cfg.vocab)
        items, counts, errors = (t.cpu().numpy() for t in merged)
        live = items != EMPTY
        n = int(state.n.sum())
        heavy = np.flatnonzero(f * cfg.sketch.k_counters > n)
        return {"n": n, "distinct": int((f > 0).sum()), "heavy": int(heavy.size),
                "recall": (float(np.isin(heavy, items[live]).mean())
                           if heavy.size else 1.0),
                "bound_violations": int(
                    ((counts[live] - errors[live]) > f[items[live]]).sum()
                    + (f[items[live]] > counts[live]).sum())}

    def pin(c, kernel):
        return dataclasses.replace(c, sketch=dataclasses.replace(c.sketch, kernel=kernel))

    @contextlib.contextmanager
    def f32_matmuls():
        """TF32 off, so the card's f32 products are f32 as the CPU's are."""
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    @contextlib.contextmanager
    def routing_recorded():
        """Record, for every MoE router top-k taken inside, the number of
        distinct experts it picked and the smallest gap between a token's
        k-th and (k+1)-th probability (a host sync per layer: checks only)."""
        from repro_torch.models import moe as moe_mod
        real = moe_mod.top_k
        seen = {"distinct": [], "gap": []}

        def recording(probs, k):
            vals, idx = real(probs, k)
            seen["distinct"].append(int(idx.unique().numel()))
            top = torch.sort(probs, dim=-1, descending=True).values
            seen["gap"].append(float((top[..., k - 1] - top[..., k]).min()))
            return vals, idx
        moe_mod.top_k = recording
        try:
            yield seen
        finally:
            moe_mod.top_k = real

    def lm_serve_phase(lm_cfg, smoke_name):
        """Phases 10, 12a and 13a (see the module docstring) on ``lm_cfg``
        at full width: returns the JSON line's fields, each arm's kernel
        launches under ``arms``."""
        from repro_torch.launch.serve import pad_seq
        from repro_torch.models import moe as moe_mod

        b, prompt_len, gen, every = LM_BATCH, LM_PROMPT, LM_GEN, LM_REPORT_EVERY
        is_moe = lm_cfg.moe is not None
        name = lm_cfg.name
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = M.init_params(lm_cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = model.state_dict()
        param_bytes = nbytes(*params.values())
        # what one decode step reads at least: every weight but the
        # embedding table (B rows of it), and the cache up to the step's
        # position. For an MoE model that is what the capacity dispatch
        # reads (every expert of every layer); the routed experts alone are
        # counted below from this run's routing
        step_weight_bytes = param_bytes - nbytes(model.embed) \
            + b * lm_cfg.d_model * model.embed.element_size()
        cache_bytes_per_pos = sum(nbytes(t) for t in M.cache_shapes(lm_cfg, b, 1).values())
        step_flops = 2 * b * (M.param_count(lm_cfg, active_only=True)
                              + (0 if model.lm_head is None else model.lm_head.numel()))
        # the matrix products run on bf16 tensor cores: each step's bound is
        # the larger of its bytes over the memory rate and its FLOPs over
        # the bf16 peak (the bytes, by far)
        ops_ms = step_flops / BF16_OPS_PER_S * 1e3
        bytes_ms = [(step_weight_bytes + cache_bytes_per_pos * (prompt_len + i + 1))
                    / HBM_BYTES_PER_S * 1e3 for i in range(1, gen)]
        bounds = [(max(t, ops_ms), "bytes" if t >= ops_ms else "operations")
                  for t in bytes_ms]

        arms = {}
        for kernel in ("auto", "cuda"):
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            with use_plan(plan):
                out = run_serve(pin(lm_cfg, kernel), batch=b, prompt_len=prompt_len,
                                gen=gen, report_every=every, k_majority=16, seed=0,
                                device="cuda", model=model)
            launched = read_counts()
            peak = torch.cuda.max_memory_allocated()
            tokens = out["tokens"]
            # b) the same tokens in the same chunks through a sorted engine
            ref_cfg = pin(lm_cfg, "sorted")
            engine = SK.token_engine(ref_cfg.sketch, 1, device=dev)
            ref_state = SK.init_token_sketch(ref_cfg.sketch, 1, chunk=b, device=dev)
            for i in range(gen):
                ref_state = SK.update_token_sketch(
                    engine, ref_state, torch.from_numpy(tokens[:, i:i + 1]).to(dev))
            got, want = state_to_numpy(out["sketch"]), state_to_numpy(ref_state)
            if not all(np.array_equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} serve {kernel}: the token sketch != sorted's")
            guarantees = sketch_guarantees(lm_cfg, out["sketch"], tokens)
            if guarantees["recall"] != 1.0 or guarantees["bound_violations"] \
                    or guarantees["n"] != tokens.size:
                raise AssertionError(f"{name} serve {kernel}: guarantees {guarantees}")
            # c) the sketch path launched the kernels
            if sum(v for k_, v in launched.items() if k_ != "ss_combine_match_dense") <= 0:
                raise AssertionError(f"{name} serve {kernel}: no ss_* kernel launched")
            t = out["timings"]
            arms[kernel] = {
                "prefill_ms": t["prefill_ms"], "decode_ms_per_step": t["decode_ms_per_step"],
                "step_ms": t["step_ms"],
                "step_host_ms_mean": float(np.mean(t["step_host_s"][1:])) * 1e3,
                "sketch_host_ms_mean": float(np.mean(t["sketch_host_s"][1:])) * 1e3,
                "sketch_host_ms_max": float(np.max(t["sketch_host_s"][1:])) * 1e3,
                "tok_per_s": t["tok_per_s"], "decode_s": t["decode_s"],
                "max_memory_allocated": peak, "launches": launched,
                "sketch_equals_sorted": True, "guarantees": guarantees,
                "reports": [{k: r[k] for k in ("step", "version", "n")}
                            | {"top": r["top"][:3], "guaranteed": len(r["guaranteed"])}
                            for r in out["reports"]],
                "sample": tokens[0, :8].tolist()}

        # a) teacher-forced decode against the forward over the same 72
        # tokens. For an MoE model this is printed, not checked: a decode
        # step never drops (cap ≥ 1 and a token's k experts are distinct)
        # while the 72-token forward at the configured capacity does, and
        # even at capacity factor E/k (no drops) the router's bf16 logits
        # (rounded to bf16 as the JAX package's are) come out of a 288-row
        # and a 4-row product rounded apart, which sends some tokens to
        # another expert. Check d) holds the MoE decode steps against a
        # no-drop forward at f32, where the routing agrees
        forced = 8
        seq = TokenStream(lm_cfg.vocab, b, prompt_len + forced).next()["tokens"]
        seq = torch.from_numpy(seq).to(dev)
        lm_plan = ShardingPlan(lm_cfg)
        routed, count_sums = [], []
        no_drop = lm_cfg if not is_moe else dataclasses.replace(
            lm_cfg, moe=dataclasses.replace(
                lm_cfg.moe, capacity_factor=lm_cfg.moe.n_experts / lm_cfg.moe.top_k))
        with torch.no_grad():
            full, _ = M.forward(model, {"tokens": seq}, no_drop)
            dropping = (M.forward(model, {"tokens": seq}, lm_cfg)[0][:, prompt_len:]
                        if is_moe else None)
            _, cache = S.make_prefill_step(lm_cfg, lm_plan)(model, {"tokens": seq[:, :prompt_len]})
            cache = {k: pad_seq(v, prompt_len + forced) for k, v in cache.items()}
            errs, agree, dropping_errs = [], 0, []
            for i in range(prompt_len, prompt_len + forced):
                with routing_recorded() as seen:
                    lg, cache, aux = M.decode_step(model, cache, seq[:, i:i + 1], i, lm_cfg)
                errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
                agree += int((lg[:, 0].argmax(-1) == full[:, i].argmax(-1)).sum())
                if is_moe:
                    routed.append(seen["distinct"])
                    count_sums.append(int(aux["expert_counts"].sum()))
                    dropping_errs.append(float(
                        (lg[:, 0] - dropping[:, i - prompt_len]).abs().max()))
            top = float(full[:, prompt_len:].abs().max())
            # where the decode step's device time goes: one step at the last
            # position again (it rewrites the same cache slice), under the profiler
            per_op = profiled(lambda: M.decode_step(model, cache, seq[:, -1:],
                                                    prompt_len + forced - 1, lm_cfg), 3)
        tol = LM_TOL_STEPS * top
        if not is_moe and not max(errs) <= tol:
            raise AssertionError(f"{name} serve a): decode vs forward {max(errs)} > {tol}")
        per_step_assignments = b * (lm_cfg.moe.top_k if is_moe else 0) * lm_cfg.n_layers
        if is_moe and count_sums != [per_step_assignments] * forced:
            raise AssertionError(f"{name} serve a): expert counts a step {count_sums} "
                                 f"!= {per_step_assignments}")
        busy_ms = sum(t for t, _ in per_op.values()) / 3 / 1e3
        top_ops = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:6]
        del full, cache, dropping

        family = {}
        if lm_cfg.mla is not None:
            mcfg = lm_cfg.mla
            elt = model.embed.element_size()
            latent = lm_cfg.n_layers * (mcfg.kv_lora_rank + mcfg.qk_rope_head_dim) * elt
            # a GQA (here MHA: 40 kv heads) cache of the same heads keeps k
            # at nope + rope and v at v_head_dim a head
            mha = lm_cfg.n_layers * lm_cfg.n_heads * (
                mcfg.qk_nope_head_dim + mcfg.qk_rope_head_dim + mcfg.v_head_dim) * elt
            family["cache_bytes_per_token"] = {"latent": latent, "gqa_same_heads": mha,
                                               "ratio": mha / latent}
        if is_moe:
            mcfg = lm_cfg.moe
            expert_bytes = 3 * lm_cfg.d_model * mcfg.d_ff_expert * model.embed.element_size()
            shared = step_weight_bytes - lm_cfg.n_layers * mcfg.n_experts * expert_bytes
            routed_bytes = [shared + sum(step) * expert_bytes for step in routed]
            pos_mean = prompt_len + forced / 2
            family["decode_bounds"] = {
                "routed_experts_ms": (float(np.mean(routed_bytes)) + cache_bytes_per_pos
                                      * pos_mean) / HBM_BYTES_PER_S * 1e3,
                "routed_distinct_experts_per_layer_mean": float(np.mean(routed)),
                "capacity_dispatch_ms": (step_weight_bytes + cache_bytes_per_pos * pos_mean)
                / HBM_BYTES_PER_S * 1e3,
                "note": "routed: the weights of the experts this run's decode steps "
                        "routed to (checked steps), every other weight, the cache; "
                        "capacity dispatch: every expert of every layer"}
            family["expert_counts_per_decode_step"] = count_sums

        # d) the smoke arch on the card against the CPU, same weights, f32
        smoke = get_smoke_arch(smoke_name)
        with f32_matmuls():
            cpu_model = M.init_params(smoke, torch.Generator().manual_seed(0), "cpu")
            card_model = M.build_params(smoke, dev)
            card_model.load_state_dict(cpu_model.state_dict())
            kw = dict(batch=b, prompt_len=32, gen=16, report_every=8, k_majority=16, seed=0)
            on_cpu = run_serve(smoke, device="cpu", model=cpu_model, **kw)
            with use_plan(plan):
                on_card = run_serve(smoke, device="cuda", model=card_model, **kw)
            both = torch.from_numpy(np.concatenate([on_cpu["prompt"], on_cpu["tokens"]], axis=1))
            counts, gaps, no_drop_errs = [], [], []       # the CPU's, then the card's
            with torch.no_grad():
                lg_cpu, _ = M.forward(cpu_model, {"tokens": both}, smoke)
                lg_card, _ = M.forward(card_model, {"tokens": both.to(dev)}, smoke)
                if smoke.moe is not None:
                    # the decode steps' expert counts on both devices, and
                    # their logits against a forward that drops nothing
                    # (capacity factor E/k) on the same device
                    smoke_no_drop = dataclasses.replace(smoke, moe=dataclasses.replace(
                        smoke.moe, capacity_factor=smoke.moe.n_experts / smoke.moe.top_k))
                    for where, mdl in ((torch.device("cpu"), cpu_model), (dev, card_model)):
                        ref, _ = M.forward(mdl, {"tokens": both.to(where)}, smoke_no_drop)
                        c = M.init_cache(smoke, b, both.shape[1], device=where)
                        counts.append([])
                        with routing_recorded() as seen:
                            for i in range(both.shape[1]):
                                lg, c, aux = M.decode_step(mdl, c, both[:, i:i + 1].to(where),
                                                           i, smoke)
                                counts[-1].append(aux["expert_counts"].tolist())
                                no_drop_errs.append(float((lg[:, 0] - ref[:, i]).abs().max()))
                        gaps.extend(seen["gap"])
        d_err = max(float((on_card["prefill_logits"] - on_cpu["prefill_logits"]).abs().max()),
                    float((lg_card.cpu() - lg_cpu).abs().max()))
        if not d_err <= 1e-4:
            raise AssertionError(f"{name} serve d): card vs CPU logits {d_err} > 1e-4")
        if not np.array_equal(on_card["tokens"], on_cpu["tokens"]):
            raise AssertionError(f"{name} serve d): card and CPU emitted other tokens")
        if not all(np.array_equal(x, y) for x, y in zip(state_to_numpy(on_card["sketch"]),
                                                         state_to_numpy(on_cpu["sketch"]))):
            raise AssertionError(f"{name} serve d): card and CPU token sketches differ")
        if counts and counts[0] != counts[1]:
            raise AssertionError(f"{name} serve d): card and CPU expert counts differ "
                                 f"(smallest top-k gap {min(gaps)})")
        # JAX's decode-vs-forward tolerance (tests/test_models_smoke.py)
        if no_drop_errs and not max(no_drop_errs) <= 5e-4:
            raise AssertionError(f"{name} serve d): decode vs a no-drop forward "
                                 f"{max(no_drop_errs)} > 5e-4")
        del model, params, card_model
        torch.cuda.empty_cache()

        if is_moe:
            # e) one MoE layer at full width, f32, capacity factor 8 (no
            # drops) against every token through its top-k experts computed
            # expert by expert (JAX tests/test_moe.py's dense reference):
            # within 1e-4 of outputs of order 1, the same f32 products summed
            # in other orders
            lcfg = dataclasses.replace(
                lm_cfg, param_dtype="float32", compute_dtype="float32",
                moe=dataclasses.replace(lm_cfg.moe, capacity_factor=8.0))
            layer = moe_mod.MoE(lcfg, dtype=torch.float32, device=dev)
            layer.init_weights(torch.Generator(device=dev).manual_seed(1))
            x = torch.randn((2, 64, lcfg.d_model), generator=torch.Generator(device=dev)
                            .manual_seed(2), device=dev)
            k_ = lcfg.moe.top_k
            with torch.no_grad(), f32_matmuls():
                y, laux = moe_mod.moe_layer(layer, x, lcfg)
                xt = x.reshape(-1, lcfg.d_model)
                top_p, top_e = moe_mod.top_k(torch.softmax(xt @ layer.router, -1), k_)
                if lcfg.moe.router_norm_topk:
                    top_p = top_p / top_p.sum(-1, keepdim=True)
                ref = torch.zeros_like(xt)
                for e in range(lcfg.moe.n_experts):
                    hit = top_e == e                               # (T, k)
                    rows = hit.any(-1)
                    if not bool(rows.any()):
                        continue
                    xe = xt[rows]
                    out = (torch.nn.functional.silu(xe @ layer.w_gate[e])
                           * (xe @ layer.w_up[e])) @ layer.w_down[e]
                    ref[rows] += (top_p[rows] * hit[rows]).sum(-1, keepdim=True) * out
            e_err = float((y.reshape(-1, lcfg.d_model) - ref).abs().max())
            if not (e_err <= 1e-4 and int(laux["expert_counts"].sum()) == xt.shape[0] * k_):
                raise AssertionError(f"{name} serve e): MoE layer vs dense reference {e_err}")
            family["check_e_dense_reference"] = {
                "tokens": xt.shape[0], "experts": lcfg.moe.n_experts, "top_k": k_,
                "capacity_factor": 8.0, "dtype": "float32", "max_abs_err": e_err,
                "max_abs_out": float(ref.abs().max()), "tolerance": 1e-4}
            del layer, x, y, ref
            torch.cuda.empty_cache()

        return {
            "arch": lm_cfg.name, "dtype": lm_cfg.param_dtype, "layers": lm_cfg.n_layers,
            "d_model": lm_cfg.d_model, "heads": [lm_cfg.n_heads, lm_cfg.n_kv_heads],
            "d_ff": lm_cfg.d_ff, "vocab": lm_cfg.vocab, "params": M.param_count(
                lm_cfg, include_embed=True), "param_bytes": param_bytes,
            "batch": b, "prompt_len": prompt_len, "gen": gen, "report_every": every,
            "k_counters": lm_cfg.sketch.k_counters, "init_s": init_s,
            "decode_bound_ms": float(np.mean([x[0] for x in bounds])),
            "decode_bound_by": bounds[0][1], "decode_ops_ms": ops_ms,
            "step_read_bytes_first_last": [
                step_weight_bytes + cache_bytes_per_pos * (prompt_len + 2),
                step_weight_bytes + cache_bytes_per_pos * (prompt_len + gen)],
            "arms": arms, **family,
            "decode_profile": {"device_busy_ms": busy_ms,
                               "kernels_per_step": sum(n for _, n in per_op.values()) / 3,
                               "top_ops": {key[:60]: {"ms": t / 3 / 1e3, "calls": n / 3}
                                           for key, (t, n) in top_ops}},
            "check_a_decode_vs_forward": {"positions": forced, "max_abs_err": max(errs),
                                          "per_position": errs, "max_abs_logit": top,
                                          "tolerance": None if is_moe else tol,
                                          "checked": not is_moe, "argmax_agree": agree,
                                          "argmax_of": b * forced,
                                          **({"forward_capacity_factor":
                                              no_drop.moe.capacity_factor,
                                              "vs_forward_at_configured_capacity":
                                              dropping_errs} if is_moe else {})},
            "check_b_sketch": "auto and cuda bitwise sorted; recall 1.0, 0 violations",
            "check_c_launches": "at least one ss_* launch in each arm's launches",
            "check_d_card_vs_cpu": {"arch": smoke.name, "dtype": smoke.param_dtype,
                                    "max_abs_err": d_err, "tolerance": 1e-4,
                                    "tokens_equal": True, "sketch_equal": True,
                                    **({"expert_counts_equal": True,
                                        "min_topk_gap": min(gaps),
                                        "decode_vs_no_drop_forward": max(no_drop_errs),
                                        "decode_vs_no_drop_tolerance": 5e-4}
                                       if counts else {})},
        }

    # -- phase 10: the LM serving path at qwen2.5-14b's full width -------------
    # launch/serve.run_serve on the full config (bf16, 48 layers, d 5120, 40/8
    # heads, d_ff 13 824, vocab 152 064, QKV bias) with fresh seeded weights:
    # the emitted tokens go through the token sketch under auto (the measured
    # plan) and under cuda, each held against a sorted engine; decode against
    # the forward at full width; a smoke arch on the card against the CPU
    t_phase = time.perf_counter()
    lm = lm_serve_phase(get_arch("qwen2.5-14b"), "qwen2.5-14b")
    lm_serve_launches = {arm: r["launches"] for arm, r in lm["arms"].items()}
    emit({"phase": "lm_serve", "card": card, **lm,
          "seconds": time.perf_counter() - t_phase})

    def lm_train_phase(full_cfg, layers, *, smoke_name, resume_arch=None,
                       smoke_lr=3e-4):
        """Phases 11, 12b–c and 13b–c (see the module docstring): ``full_cfg``
        cut to ``layers`` layers; returns the JSON line's fields, the
        trainer's and the cuda engine's launches under ``launches``."""
        from repro_torch.launch import train as train_cli
        from repro_torch.launch.train import run_train
        from repro_torch.optim import adamw

        cfg = dataclasses.replace(full_cfg, n_layers=layers)
        name = cfg.name
        is_moe = cfg.moe is not None
        b, seq, steps = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS
        if cfg.remat != "full" or cfg.param_dtype != "bfloat16":
            raise AssertionError(f"{name} train: {cfg.remat} remat, {cfg.param_dtype}")

        # a) full width, cut in depth, 16 steps, the sketch under auto
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        free_before = torch.cuda.mem_get_info()[0]
        zero_counts()
        with use_plan(plan):
            out = run_train(cfg, steps=steps, batch=b, seq=seq, lr=3e-4, skew=1.1,
                            merge_every=LM_TRAIN_MERGE, log_every=steps, seed=0,
                            device="cuda", ckpt_dir=None)
        launched = read_counts()
        peak = torch.cuda.max_memory_allocated()
        state, tokens = out["state"], out["tokens"]
        losses, gnorms, lrs = out["losses"], out["grad_norms"], out["lrs"]
        if not (len(losses) == steps and all(math.isfinite(x) for x in losses + gnorms)
                and min(gnorms) > 0):
            raise AssertionError(f"{name} train a): losses {losses}, grad norms {gnorms}")
        if int(state.opt.count) != steps:
            raise AssertionError(f"{name} train a): opt.count {int(state.opt.count)} != {steps}")
        named = dict(state.params.named_parameters())
        not_master = [n for n, p in named.items()
                      if not torch.equal(p, state.opt.master[n].to(p.dtype))]
        if not_master:
            raise AssertionError(f"{name} train a): params != their masters: {not_master[:4]}")
        late = float(np.mean(losses[12:16]))
        if not late < losses[0]:
            raise AssertionError(f"{name} train a): mean loss of steps 13-16 {late} >= "
                                 f"step 1's {losses[0]}")
        # the same batches through a sorted and a cuda engine, in the same chunks
        replays, cuda_launches = {}, None
        for kernel in ("sorted", "cuda"):
            ref_cfg = pin(cfg, kernel)
            engine = SK.token_engine(ref_cfg.sketch, 1, device=dev)
            ref = SK.init_token_sketch(ref_cfg.sketch, 1, device=dev)
            zero_counts()
            for i in range(steps):
                ref = SK.update_token_sketch(
                    engine, ref, torch.from_numpy(tokens[i].reshape(b, seq)).to(dev))
            if kernel == "cuda":
                cuda_launches = read_counts()
            replays[kernel] = state_to_numpy(ref)
        got = state_to_numpy(state.token_sketch)
        for kernel, want in replays.items():
            if not all(np.array_equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} train a): the trainer's sketch != {kernel}'s")
        guarantees = sketch_guarantees(cfg, state.token_sketch, tokens)
        if guarantees["recall"] != 1.0 or guarantees["bound_violations"] \
                or guarantees["n"] != tokens.size:
            raise AssertionError(f"{name} train a): guarantees {guarantees}")
        if launched["ss_fused_ingest"] < 1 or cuda_launches["ss_combine_match"] < 1:
            raise AssertionError(f"{name} train a): launches {launched} / cuda {cuda_launches}")
        moe_fields = {}
        if is_moe:
            # the expert sketch: fed every step the router's counts, which sum
            # to tokens·top_k·layers; bitwise a sorted expert engine fed the
            # same counts; its merges launched ss_combine_match every step
            aux_losses, counts = out["moe_aux_losses"], out["expert_counts"]
            per_step = b * seq * cfg.moe.top_k * cfg.n_layers
            if not (len(aux_losses) == steps and all(math.isfinite(x) for x in aux_losses)):
                raise AssertionError(f"{name} train a): moe aux losses {aux_losses}")
            if counts.shape != (steps, cfg.moe.n_experts) \
                    or counts.sum(1).tolist() != [per_step] * steps:
                raise AssertionError(f"{name} train a): expert counts a step "
                                     f"{counts.sum(1).tolist()} != {per_step}")
            ref_sk = pin(cfg, "sorted").sketch
            engine = SK.expert_engine(ref_sk, device=dev)
            ref = SK.init_expert_sketch(ref_sk, device=dev)
            for row in counts:
                ref = SK.update_expert_sketch(engine, ref, torch.from_numpy(row).to(dev))
            if not all(np.array_equal(x, y) for x, y in zip(state_to_numpy(state.expert_sketch),
                                                             state_to_numpy(ref))):
                raise AssertionError(f"{name} train a): the expert sketch != sorted's")
            if launched["ss_combine_match"] < steps:
                raise AssertionError(f"{name} train a): the expert sketch launched "
                                     f"ss_combine_match {launched['ss_combine_match']} times")
            items = state.expert_sketch.items[0].cpu().numpy()
            ecounts = state.expert_sketch.counts[0].cpu().numpy()
            order = np.argsort(-ecounts, kind="stable")[:5]
            moe_fields = {"moe_aux_losses": aux_losses,
                          "expert_counts_per_step": per_step,
                          "expert_sketch_n": int(state.expert_sketch.n.sum()),
                          "expert_sketch_top5": [[int(items[i]), int(ecounts[i])]
                                                 for i in order],
                          "expert_sketch": "bitwise a sorted expert engine fed the same counts"}

        # the bounds of one step: matrix FLOPs (every 2-D weight but the
        # embedding table, a gather, and each expert stack at top_k/E of its
        # size, the experts a token runs through) at T tokens, forward 2·N·T
        # and backward 4·N·T, and causal attention (QK^T and PV over the
        # lower triangle, B·H·(d_qk + d_v)·S² a layer forward, twice that
        # backward); full remat runs each layer's forward once more. The
        # optimizer must read each bf16 grad and write each bf16 param once,
        # and read and write the f32 master, m and v: 28 B a parameter.
        t = b * seq
        n_all = sum(p.numel() for p in named.values())
        n_head = cfg.d_model * cfg.vocab
        share = cfg.moe.top_k / cfg.moe.n_experts if is_moe else 1.0
        n_layers = int(sum(p.numel() * (share if p.dim() == 3 else 1)
                           for pname, p in named.items()
                           if p.dim() in (2, 3) and pname.startswith("layers.")))
        d_qk, d_v = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim)
                     if cfg.mla is not None else (cfg.hd, cfg.hd))
        att_fwd = b * cfg.n_heads * (d_qk + d_v) * seq * seq * cfg.n_layers
        fwd = 2 * t * (n_layers + n_head) + att_fwd
        model_flops = 3 * fwd
        recompute_flops = 2 * t * n_layers + att_fwd
        opt_bytes = 28 * n_all
        timing = out["timings"]
        steady = slice(1, steps)
        step_ms = timing["step_ms"][steady]
        flops_ms = model_flops / BF16_OPS_PER_S * 1e3
        opt_bound_ms = opt_bytes / HBM_BYTES_PER_S * 1e3

        # one more step under the profiler (after the checks: it moves the state)
        train_step = S.make_train_step(cfg, ShardingPlan(cfg), device=dev,
                                       lr_fn=adamw.cosine_schedule(3e-4, 20, steps))
        batch = TokenStream(cfg.vocab, b, seq).next()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        holder = [state]

        def one_step():
            holder[0], _ = train_step(holder[0], batch)

        with use_plan(plan):
            per_op = profiled(one_step, 1)
        busy_ms = sum(t_us for t_us, _ in per_op.values()) / 1e3
        gemm = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)
        gemm_ms = sum(t_us for key, (t_us, _) in per_op.items() if gemm.search(key)) / 1e3
        by_name = {}            # kernels by the first 60 characters of their names
        for key, (t_us, n) in per_op.items():
            ms0, n0 = by_name.get(key[:60], (0.0, 0))
            by_name[key[:60]] = (ms0 + t_us / 1e3, n0 + n)
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        del state, holder, named, out, batch, train_step
        torch.cuda.empty_cache()

        # b) the smoke arch on the card and on the CPU, the same f32 weights
        smoke = get_smoke_arch(smoke_name)
        kw = dict(steps=4, batch=4, seq=64, lr=smoke_lr, merge_every=2, log_every=4, seed=0,
                  ckpt_dir=None)
        with f32_matmuls():
            cpu_model = M.init_params(smoke, torch.Generator().manual_seed(0), "cpu")
            card_model = M.build_params(smoke, dev)
            card_model.load_state_dict(cpu_model.state_dict())
            on_cpu = run_train(smoke, device="cpu", model=cpu_model, **kw)
            with use_plan(plan):
                on_card = run_train(smoke, device="cuda", model=card_model, **kw)
        loss_rel = max(abs(x / y - 1) for x, y in zip(on_card["losses"], on_cpu["losses"]))
        gnorm_rel = max(abs(x / y - 1) for x, y in zip(on_card["grad_norms"],
                                                       on_cpu["grad_norms"]))
        lr_sum = sum(on_cpu["lrs"])
        cpu_params = on_cpu["state"].params.state_dict()
        param_err = max(float((p.cpu() - cpu_params[n]).abs().max())
                        for n, p in on_card["state"].params.state_dict().items())
        param_tol = 4 * lr_sum + 1e-5
        if not (loss_rel <= 1e-4 and gnorm_rel <= 1e-3 and param_err <= param_tol):
            raise AssertionError(f"{name} train b): losses {loss_rel}, grad norms {gnorm_rel}, "
                                 f"params {param_err} > {param_tol}")
        if not np.array_equal(on_card["tokens"], on_cpu["tokens"]):
            raise AssertionError(f"{name} train b): card and CPU trained on other batches")
        sketches = ("token_sketch", "expert_sketch") if smoke.moe is not None \
            else ("token_sketch",)
        for sk_name in sketches:
            if not all(np.array_equal(x, y) for x, y in zip(
                    state_to_numpy(getattr(on_card["state"], sk_name)),
                    state_to_numpy(getattr(on_cpu["state"], sk_name)))):
                raise AssertionError(f"{name} train b): card and CPU {sk_name}es differ")
        del cpu_model, card_model, on_cpu, on_card

        # c) launch/train.main on the card: crash at 4, resume to 8, against
        # an uninterrupted run
        check_c = None
        if resume_arch is not None:
            argv = ["--arch", resume_arch, "--smoke", "--steps", "8", "--batch", "2",
                    "--seq", "64", "--ckpt-every", "4", "--merge-every", "4",
                    "--log-every", "1"]
            with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp, use_plan(plan):
                whole = train_cli.main([*argv, "--ckpt-dir", f"{tmp}/whole"])
                crash_code = None
                try:
                    train_cli.main([*argv, "--ckpt-dir", f"{tmp}/crash", "--crash-at", "4"])
                except SystemExit as e:
                    crash_code = e.code
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    resumed = train_cli.main([*argv, "--ckpt-dir", f"{tmp}/crash"])
            print(printed.getvalue(), end="", flush=True)
            if crash_code != 42 or "[resume] restored step 4" not in printed.getvalue():
                raise AssertionError(f"{name} train c): crash code {crash_code}, no resume line")
            if not np.array_equal(resumed["tokens"], whole["tokens"][4:]):
                raise AssertionError(f"{name} train c): the resumed run trained on other batches")
            resumed_sketches = ("token_sketch", "expert_sketch") \
                if get_smoke_arch(resume_arch).moe is not None else ("token_sketch",)
            for sk_name in resumed_sketches:
                if not all(np.array_equal(x, y) for x, y in zip(
                        state_to_numpy(getattr(resumed["state"], sk_name)),
                        state_to_numpy(getattr(whole["state"], sk_name)))):
                    raise AssertionError(f"{name} train c): the resumed run's {sk_name} differs")
            resume_rel = max(abs(x / y - 1) for x, y in zip(resumed["losses"],
                                                            whole["losses"][4:]))
            if not resume_rel <= LM_RESUME_RTOL:
                raise AssertionError(f"{name} train c): losses of steps 5-8 {resume_rel} off")
            resume_params_err = max(
                float((p - whole["state"].params.state_dict()[n]).abs().max())
                for n, p in resumed["state"].params.state_dict().items())
            check_c = {"arch": resume_arch, "resumed_at": 4, "steps": 8,
                       "loss_rel": resume_rel, "tolerance": LM_RESUME_RTOL,
                       "bitwise": resume_rel == 0.0, "params_max_abs_err": resume_params_err,
                       "tokens_equal": True, "sketches_equal": list(resumed_sketches)}
            del whole, resumed
        torch.cuda.empty_cache()

        def mean_of(key):
            return float(np.mean(timing[key][steady]))

        return {
            "arch": cfg.name, "dtype": cfg.param_dtype, "layers": cfg.n_layers,
            "reduced": {"n_layers": [full_cfg.n_layers, layers]},
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "remat": cfg.remat, "params": n_all,
            "matmul_params": n_layers + n_head, "batch": b, "seq": seq, "steps": steps,
            "merge_every": LM_TRAIN_MERGE, "k_counters": cfg.sketch.k_counters,
            "losses": losses, "grad_norms": gnorms, "lrs": lrs, **moe_fields,
            "step_ms_mean": float(np.mean(step_ms)), "step_ms_p50": float(np.median(step_ms)),
            "step_ms": timing["step_ms"], "step_host_ms_mean": mean_of("step_host_ms"),
            "fwd_bwd_ms_mean": mean_of("fwd_bwd_ms"),
            "optimizer_ms_mean": mean_of("optimizer_ms"),
            "sketch_ms_mean": mean_of("sketch_ms"),
            "sketch_host_ms_mean": mean_of("sketch_host_ms"),
            "sketch_host_ms_max": float(np.max(timing["sketch_host_ms"][steady])),
            "tok_per_s_steady": t / (float(np.mean(step_ms)) / 1e3),
            "tok_per_s_loop": timing["tok_per_s"], "loop_s": timing["loop_s"],
            "model_flops_per_step": model_flops, "recompute_flops_per_step": recompute_flops,
            "flops_bound_ms": flops_ms,
            "flops_bound_ms_with_recompute": (model_flops + recompute_flops)
            / BF16_OPS_PER_S * 1e3,
            "optimizer_bytes": opt_bytes, "optimizer_bound_ms": opt_bound_ms,
            "step_bound_ms": flops_ms + opt_bound_ms,
            "max_memory_allocated": peak, "free_before": free_before,
            "launches": launched, "cuda_engine_launches": cuda_launches,
            "step_profile": {"device_busy_ms": busy_ms,
                             "kernels": sum(n for _, n in per_op.values()),
                             "gemm_ms": gemm_ms,
                             "top_ops": {key: {"ms": ms, "calls": n}
                                         for key, (ms, n) in top_ops}},
            "check_a": {"late_loss_mean": late, "first_loss": losses[0],
                        "sketch": "bitwise sorted's and cuda's", "guarantees": guarantees},
            "check_b_card_vs_cpu": {"arch": smoke.name, "dtype": smoke.param_dtype,
                                    "steps": 4, "lr": smoke_lr, "loss_rel": loss_rel,
                                    "gnorm_rel": gnorm_rel, "param_err": param_err,
                                    "param_tol": param_tol, "tokens_equal": True,
                                    "sketches_equal": list(sketches)},
            "check_c_resume": check_c,
        }

    # -- phase 11: the LM training path at qwen2.5-14b's width ----------------
    # launch/train.run_train on the full config cut to 4 layers (see the
    # module docstring), the sketch under auto, held against sorted and cuda
    # engines; the smoke arch on the card against the CPU; main's crash and
    # resume on the card
    t_phase = time.perf_counter()
    lm_train = lm_train_phase(get_arch("qwen2.5-14b"), LM_TRAIN_LAYERS,
                              smoke_name="qwen2.5-14b", resume_arch="qwen2.5-14b")
    lm_train_launches = {"auto": lm_train["launches"], "cuda": lm_train["cuda_engine_launches"]}
    emit({"phase": "lm_train", "card": card, **lm_train,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 12: the MLA family, minicpm3-4b, served whole and trained -----
    # at its widths cut to 32 of 62 layers; the smoke arch trained on the
    # card against the CPU
    t_phase = time.perf_counter()
    mla_serve = lm_serve_phase(get_arch("minicpm3-4b"), "minicpm3-4b")
    lm_mla_serve_launches = {arm: r["launches"] for arm, r in mla_serve["arms"].items()}
    emit({"phase": "lm_mla_serve", "card": card, **mla_serve,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    mla_train = lm_train_phase(get_arch("minicpm3-4b"), LM_MLA_TRAIN_LAYERS,
                               smoke_name="minicpm3-4b")
    lm_mla_train_launches = {"auto": mla_train["launches"],
                             "cuda": mla_train["cuda_engine_launches"]}
    emit({"phase": "lm_mla_train", "card": card, **mla_train,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 13: the MoE family, qwen3-moe-30b-a3b, served whole and -------
    # trained at its widths cut to 4 of 48 layers, the expert sketch fed the
    # router's counts every step; main's crash and resume on mixtral's smoke
    # arch (MoE with a sliding window)
    t_phase = time.perf_counter()
    moe_serve = lm_serve_phase(get_arch("qwen3-moe-30b-a3b"), "qwen3-moe-30b-a3b")
    lm_moe_serve_launches = {arm: r["launches"] for arm, r in moe_serve["arms"].items()}
    emit({"phase": "lm_moe_serve", "card": card, **moe_serve,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    # the smoke arch's card-vs-CPU training at lr 1e-6: Adam moves a
    # parameter by ±lr whatever its gradient's size, so the two devices'
    # params part by up to 2·lr a step where a gradient near 0 differs in
    # sign; at 1e-6 the routers' probabilities stay within f32 noise and
    # both devices route alike
    moe_train = lm_train_phase(get_arch("qwen3-moe-30b-a3b"), LM_MOE_TRAIN_LAYERS,
                               smoke_name="qwen3-moe-30b-a3b", resume_arch="mixtral-8x7b",
                               smoke_lr=1e-6)
    if moe_train["max_memory_allocated"] > 75e9:
        raise AssertionError(f"lm_moe_train: peak {moe_train['max_memory_allocated']} "
                             f"> 75 GB at {LM_MOE_TRAIN_LAYERS} layers")
    lm_moe_train_launches = {"auto": moe_train["launches"],
                             "cuda": moe_train["cuda_engine_launches"]}
    emit({"phase": "lm_moe_train", "card": card, **moe_train,
          "seconds": time.perf_counter() - t_phase})

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
                "serve_launches": serve_launches[name], "obs_launches": obs_launches[name],
                "scale_launches": scale_launches[name],
                "lm_serve_launches": lm_serve_launches["auto"][name],
                "lm_serve_cuda_launches": lm_serve_launches["cuda"][name],
                "lm_train_launches": lm_train_launches["auto"][name],
                "lm_train_cuda_launches": lm_train_launches["cuda"][name],
                "lm_mla_serve_launches": lm_mla_serve_launches["auto"][name],
                "lm_mla_serve_cuda_launches": lm_mla_serve_launches["cuda"][name],
                "lm_mla_train_launches": lm_mla_train_launches["auto"][name],
                "lm_mla_train_cuda_launches": lm_mla_train_launches["cuda"][name],
                "lm_moe_serve_launches": lm_moe_serve_launches["auto"][name],
                "lm_moe_serve_cuda_launches": lm_moe_serve_launches["cuda"][name],
                "lm_moe_train_launches": lm_moe_train_launches["auto"][name],
                "lm_moe_train_cuda_launches": lm_moe_train_launches["cuda"][name],
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
