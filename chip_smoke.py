#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Twenty phases and a checkpoint line, each printing one JSON line or more:

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
   ragged shape; ids over the whole int32 range, windows whose high digits
   are constant or whose digits all vary, W not a power of two, all-equal
   and all-distinct windows, counts above 2^24 and 2^32 with ties in low
   digits; and for the flush kernel's hash table the main path's state at
   zipf 1.8, 64 all-distinct windows at int64, 2 048 ids and W distinct
   ids that all share one home slot of the public Fibonacci hash (each
   held within twice the all-distinct window's device time: the table's
   hash is keyed by a salt drawn each launch), one id among EMPTYs, and
   k 1; for the COMBINE's hash join of s2's ids the tree's last rounds at
   k 2048 (4 pairs and 1), disjoint and identical ids, k 1, ids of one
   home slot in both summaries (held within twice the COMBINE shape's
   device time), counts spread over 2^30 and 2^60, and the same inputs
   under two salts, bit for bit; each flush beside the time of the
   sort-based kernel the hash table replaced, and each COMBINE beside the
   kernel that sorted s2's (id, slot) keys), and the shapes above
   the shared-memory
   path's limits, on the cluster path or the workspace path as
   ``ss_ingest.path_for`` picks (the planned flush B 64, k 2048, W 65 536 at
   int32 and int64; k 4000 and 8000 at W 16 384, B 8 and B 64; W 65 535,
   65 536 and 65 537; k 2049 × W 16 385; k 16 384 × an all-distinct
   W 131 072; the W where ``cluster_for`` changes C; COMBINE at k 4000,
   8000 and 16 384, int64 and tied counts at k 8000, and 4 and 1 pairs at
   k 8000), each case naming the path it took, its cluster size C and its
   time on the workspace kernel before the cluster path; the planned
   flush and the largest pool forced onto the workspace kernel too, the
   two outputs bitwise equal; then the cluster kernels' ptxas lines and
   ``cudaOccupancyMaxActiveClusters`` at each C;
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
   ``sorted`` engine's of the same geometry, its flushes through the fused
   flush's cluster path (W 65 536) and its COMBINE tree through the fused
   COMBINE, its items/s beside the rates before the workspace path and with
   the workspace path, and its flush, snapshot and query latency; then the
   paper's k sweep
   (``PAPER_STREAM_CONFIGS["paper-k-sweep"]``: k 500, 1000, 2000, 4000 and
   8000 at skew 1.1 over 10^7 ids, max id 10^6, at the main geometry) under
   ``sorted``, ``fused`` and ``auto``: each snapshot bitwise ``sorted``'s,
   the guarantees against exact counts, items/s a k and impl (at k 4000
   and 8000 beside the rates with the workspace path; their flushes must
   take the cluster path); and one tune call at k 4096 × chunk 8192
   (``--ops flush --no-reductions --check``, a temporary cache) that must
   exit 0 and flush through the cluster path;
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
   (MoE with a sliding window), the expert sketch bitwise too;
14. the hybrid and SSM families: a) phase 10's checks and numbers on
   zamba2-7b whole (bf16, 81 Mamba-2 layers, d 3584, d_state 64, 112 heads
   of 64 in 2 groups, conv 4, SSD chunk 256; a shared attention block of
   32 heads of 112 and d_ff 14 336 after every 6th layer, 13 applications;
   vocab 32 000; 6.79·10^9 parameters): the decode step writes each
   layer's f32 state and conv window in place, the step's byte bound counts
   them once read and once written, the shared block's weights once per
   application and only its k/v by position; check a) runs an f32 copy of
   the model too: its decode against its forward within
   ``LM_SSM_F32_TOL``, and the bf16 decode within the larger of
   ``LM_TOL_STEPS`` and the bf16 forward's own distance from the f32
   forward; b) phase 11a's checks and numbers cut to 24 of 81 layers (4
   periods), the FLOP bound with the SSD scan's f32 products beside the
   bf16 ones, peak memory under 75 GB, and 11b on its smoke arch; c) mamba2-130m (24 layers, d 768, d_state 128,
   24 heads of 64, vocab 50 280; 1.68·10^8 parameters) served whole with
   a)'s checks and trained whole with b)'s, and 11c on its smoke arch.
   Every path launches ``ss_fused_ingest`` under ``auto`` and
   ``ss_combine_match`` under ``cuda``;
15. the audio and vlm families: a) phase 10's checks and numbers on
   whisper-tiny whole (bf16, 4 encoder and 4 decoder layers, d 384, 6
   heads of 64, d_ff 1 536, GELU, LayerNorm, QKV bias, 1 500 frames, vocab
   51 865; 5.64·10^7 parameters): the stream's frame embeddings go through
   the encoder in the prefill, the decode step writes its k/v at its
   position and reads the cross attention's ck/cv (4, 4, 1 500, 6, 64)
   whole, which the launcher leaves unpadded; the byte bound counts the
   decoder's weights once, ck/cv whole and k/v by position; b) phase 11a's
   checks and numbers on whisper-tiny whole at B 4 × S 448 (1 500 frames a
   row), and 11b and 11c on its smoke arch; c) phase 10's checks on
   qwen2-vl-72b at full width (d 8192, 64/8 heads of 128, d_ff 29 568,
   vocab 152 064, QKV bias, M-RoPE sections (16, 24, 24)) cut to 32 of 80
   layers, a 320-token prompt whose first 256 rows are the stream's stub
   patch embeddings, the (3, B, S) M-RoPE positions, decode against the
   forward after the prompt with the same embeddings in both; d) phase
   11a's checks and numbers at 1 of its 80 layers, peak memory under 75
   GB, and 11b on its smoke arch. The depths of c) and d) are reckoned
   from ``meta`` tensors against the card's memory first (an
   ``lm_depth`` line each);
16. the sharded steps (``lm_sharded``): a world of 1 over nccl (a file
   rendezvous; no nccl raises) and a ``(1, 1)`` data × model DeviceMesh.
   a) qwen2.5-14b whole from phase 10's seed, distributed by
   ``train/steps.py``'s placements (DTensors), phase 10's prompt through
   the sharded prefill, the cache in ``cache_shardings``, 8 greedy decode
   steps with the token sketch under ``auto``: the tokens phase 10's, the
   last logits within ``LM_TOL_STEPS`` of the largest of phase 10's (the
   gap and whether it is bitwise printed), the sketch bitwise a ``sorted``
   engine fed the same tokens, ``ss_fused_ingest`` launched; decode ms
   and host ms a step, and the kernels of one step under the profiler,
   beside phase 10's. b) phase 11's cut (4 of 48 layers) from its seed,
   8 sharded train steps of its batches and schedule: losses within 1e-6
   relative of phase 11's first 8, the token sketch bitwise phase 11's
   batches through a ``sorted`` engine, ``ss_fused_ingest`` launched;
   step ms beside phase 11's. Phases 10 and 11 keep only what 16 compares
   (tokens, logits, losses), so no two full-width states are resident at
   once;
17. the sharded steps of the MLA and MoE families (``lm_sharded_families``)
   on phase 16's mesh: a) minicpm3-4b whole from phase 12a's seed, the
   latent cache in ``cache_shardings``, and b) qwen3-moe-30b-a3b whole
   (61.1 GB) under ``moe_strategy="ep"``, each as 16a against phase 12a's
   or 13a's prompt, tokens and last logits; c) qwen3-moe-30b-a3b at phase
   13b's cut under ``ep`` and d) minicpm3-4b at phase 12b's, each as 16b
   against phase 13b's or 12b's batches, losses and token sketch, and for
   c) the expert counts of every step bitwise phase 13b's, the expert
   sketch bitwise a ``sorted`` expert engine fed them and
   ``ss_combine_match`` launched every step. Decode and host ms a step,
   kernels a step, train step ms and every kernel's launches are printed
   beside phases 12's and 13's;
18. the sharded steps of the SSM, hybrid, audio and vlm families
   (``lm_sharded_rest``) on phase 16's mesh: a) mamba2-130m, b) zamba2-7b
   and c) whisper-tiny served whole and d) qwen2-vl-72b at phase 15c's
   depth (32 of 80 layers), each as 16a against phase 14c's, 14a's, 15a's
   or 15c's prompt (with the stream's frames, or patch embeddings and
   (3, B, S) positions, placed by ``batch_shardings``), tokens and last
   logits, the SSM state and conv window and whisper's ck/cv in
   ``cache_shardings``; e) zamba2-7b at phase 14b's cut (24 layers), f)
   mamba2-130m whole, g) whisper-tiny whole at B 4 × S 448 and h)
   qwen2-vl-72b at phase 15d's (1 layer), each as 16b against phase 14b's,
   14c's, 15b's or 15d's batches (with their modality inputs), losses and
   token sketch, ``LM_SHARDED_FAMILY_TRAIN_STEPS`` steps. Decode and host
   ms a step, kernels a step, train step ms and every kernel's launches are
   printed beside phases 14's and 15's. The process group is destroyed at
   the phase's end;
19. the dry run's cost analysis (``lm_dryrun``): a) ``launch/
   hlo_analysis.analyze`` over real steps on the card: a decode step of
   qwen2.5-14b whole (phase 10's seed, B 4, after a 64-token prompt), and
   mamba2-130m's decode (phase 14c's B 4, 64-token prompt) and train step
   (B 4 × S 512), each beside its own ms (host clock after a sync, one
   warm-up and ``LM_DRYRUN_STEPS`` timed, a flush of the token sketch among
   them, whose kernels launch): no step faster than its
   ``step_lower_bound_s``, and the qwen2.5-14b decode's counted bytes
   within [1, ``LM_DRYRUN_BYTES_GAP``] of phase 10's hand bound (every
   weight but the embedding table read once, B rows of it, and the cache
   up to the position); b) ``python -m repro_torch.launch.dryrun --auto``
   in one subprocess a cell, all started together (a one-process fake
   world of 256 ranks and fake cuda tensors of its own): mamba2-130m ×
   ``train_4k``, ``prefill_32k``, ``decode_32k`` and minicpm3-4b ×
   ``decode_32k`` (40 heads on a ``model`` of 16) and qwen2.5-14b ×
   ``prefill_32k`` (its attention tile loop counted once times its 2 080
   trips a layer) × ``single``, each within ``LM_DRYRUN_TIMEOUT``, every
   record green, its parameter counts the port's ``param_count``;
20. the examples (``repro_torch.examples``, the JAX package's
   ``examples/`` on the port) at their default sizes: ``quickstart`` and
   ``stream_frequent_items`` in this process on the card (under the
   measured plan) and then with ``--device cpu``: quickstart's printed
   lines, and every line of the stream's but the tier's ``describe()``
   (items, counts, bounds, versions, the k-majority tally), the same on
   both; ``serve_decode`` and ``train_lm_with_sketch`` (200 steps, a
   temporary ``--ckpt-dir``) as subprocesses on the card, started first:
   each exits 0, and the trainer's final oracle line reads precision and
   recall 1.000. The launches are those of the two in-process twins on
   the card. The line prints numpy's version and the sha256 of
   quickstart's stream on this machine.

Each path (3, 4, 5, the planned engine, each run of the k sweep and its
tune call, 6, the checkpoint line, 7 and its
measured-knob arm, 8, the metrics dump, 9, each arm of 10, 12a, 13a, 14a,
14c's, 15a and 15c's serving, the trainers of 11a, 12b, 13b, 14b, 14c,
15b and 15d and their ``cuda`` engines, 16a, 16b, 17a–d, 18a–h, 19a and 20's
in-process twins on the card) runs with the
kernels' launch counts set to 0 just before it and read just after. Then
the kernel table as one JSON line (each row's ``launches`` from the main
path, ``serve_launches``, ``obs_launches``, ``scale_launches``,
``lm_serve_launches``, ``lm_serve_cuda_launches``, ``lm_train_launches``
and ``lm_train_cuda_launches`` from phases 7's pinned arm, 8, 9, the two
arms of 10 and the two paths of 11a, and the same pairs ``lm_mla_*``,
``lm_moe_*``, ``lm_hybrid_*``, ``lm_ssm_*``, ``lm_audio_*`` and ``lm_vlm_*``
from phases 12, 13, 14a–b, 14c, 15a–b and 15c–d, and
``lm_sharded_serve_launches`` and ``lm_sharded_train_launches`` from 16a
and 16b, ``lm_sharded_mla_serve_launches``, ``lm_sharded_moe_serve_launches``,
``lm_sharded_moe_train_launches`` and ``lm_sharded_mla_train_launches`` from
17a–d, ``lm_sharded_{ssm,hybrid,audio,vlm}_{serve,train}_launches`` from
18a–h, ``lm_dryrun_launches`` from 19a, ``examples_launches`` from 20), the
card's name and power limit,
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
SCALAR_OPS_PER_S = 67e12     # H100 non-tensor-core float32 peak: int32 compares, f32 products
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
N_MAIN = 1 << 26             # ids in the main-path stream (256 MiB of int32 on the card)
FEED_BLOCKS = 16             # host blocks of the runtime phase (2^22 ids each)
SERVE_BLOCK = 1 << 20        # ids per host block of the serving phase: one full buffer
TENANTS, K, CHUNK, DEPTH = 64, 2048, 2048, 8
SKEWS = (1.1, 1.8)           # the paper's Table I
MAX_ID = 10**6
IMPLS = ("cuda", "sorted", "fused")  # every snapshot is held against sorted's
# the fused kernels' shared-memory cases before this port's current kernels,
# printed beside this run's: the flush's on the sort-based kernel the hash
# table replaced, the COMBINE's on the kernel that sorted s2's (id, slot)
# keys, which the hash join replaced (ms per call and device ms, the mean
# of two turns: tools/smem_phases.py, each old kernel built in the same call
# as its successor, on NVIDIA H100 80GB HBM3, 700.00 W)
SMEM_MS_BEFORE = {
    "ss_fused_ingest": {
        "flush": (0.0988, 0.0904), "int64": (0.1112, 0.1067),
        "empty_window": (0.0393, 0.0351), "ties": (0.0932, 0.0879),
        "partial": (0.0922, 0.0886), "ragged": (0.0401, 0.0201),
        "big_ids": (0.121, 0.1174), "big_ids_int64": (0.1409, 0.1374),
        "high_digits_constant": (0.1037, 0.099), "all_digits_vary": (0.1186, 0.1126),
        "w_not_pow2": (0.0677, 0.0631), "all_equal": (0.0404, 0.0353),
        "all_distinct": (0.1166, 0.1122), "big_counts": (0.0991, 0.0942),
        "big_counts_int64": (0.1157, 0.1106), "flush_skew_1_8": (0.0633, 0.0597),
        "all_distinct_b64_int64": (0.141, 0.1377), "one_chain": (0.0937, 0.0894),
        "chain_distinct": (0.1507, 0.1472), "one_id_and_empty": (0.067, 0.0623),
        "k_1": (0.0823, 0.078)},
    "ss_fused_combine": {
        "combine": (0.0687, 0.0441), "int64": (0.0813, 0.0526), "ties": (0.0671, 0.0458),
        "partial": (0.062, 0.0434), "ragged": (0.0826, 0.0253), "big_counts": (0.0656, 0.0499),
        "big_counts_int64": (0.0792, 0.0583), "tree_b4": (0.0555, 0.0439),
        "tree_b1": (0.0551, 0.0439), "disjoint": (0.0709, 0.0464),
        "identical": (0.0524, 0.0445), "k_1": (0.0507, 0.005), "one_chain": (0.0587, 0.0511),
        "wide_counts": (0.0743, 0.0556), "huge_counts_int64": (0.0792, 0.073)}}
# the fused kernels' cases above the shared-memory path's limits on the
# workspace kernel, before the cluster path took them (ms per call and
# device ms, this script on NVIDIA H100 80GB HBM3, 700.00 W, the workspace
# path's first chip runs), printed beside this run's
WORKSPACE_MS_BEFORE = {
    "ss_fused_ingest": {
        "planned": (0.6262, 0.6147), "planned_int64": (0.6887, 0.6981),
        "k_4000": (0.1545, 0.1506), "k_8000": (0.1981, 0.1923),
        "w_65535": (0.5527, 0.5473), "w_65536": (0.5575, 0.5496), "w_65537": (0.4684, 0.4646),
        "k_2049_w_16385": (0.1281, 0.1232), "largest_pool": (2.0164, 1.9918)},
    "ss_fused_combine": {
        "k_4000": (0.0825, 0.0790), "k_8000": (0.1536, 0.1502), "k_16384": (0.3734, 0.3696),
        "k_8000_int64": (0.2151, 0.2090), "k_8000_ties": (0.1315, 0.1260)}}
# the planned engine (chunk 8192, depth 8: W 65 536) before the workspace
# path, when its flushes took ~40 plain ops under 'cuda' (the same run)
PLANNED_ITEMS_PER_S_BEFORE = 1004230267.3541641
# the planned engine with its flushes on the workspace kernel, before the
# cluster path (the same script and card)
PLANNED_ITEMS_PER_S_WORKSPACE = 3.872e9
# the paper's k sweep's items/s at k 4000 and 8000 under fused and auto with
# those flushes on the workspace kernel (the same script and card)
SWEEP_ITEMS_PER_S_WORKSPACE = {4000: {"fused": 3.86e9, "auto": 3.62e9},
                               8000: {"fused": 3.57e9, "auto": 3.66e9}}
# the paper's k sweep (configs/registry.py PAPER_STREAM_CONFIGS["paper-k-sweep"])
# at paper-default's n, skew and id range, at the main path's tenants and
# geometry (W 16 384)
PAPER_N = 10_000_000
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
# the SSM and hybrid families' check a): their bf16 models round far more
# than the dense ones (dt = softplus(x·W) rounded to bf16 feeds exp(dt·A)
# and a running state): phase 14 measured zamba2-7b's bf16 forward 1.79
# from its own f32 forward over 72 tokens and mamba2-130m's 0.65, against
# logits of ~5 (NVIDIA H100 80GB HBM3, 700 W; the line's
# bf16_forward_vs_f32_forward). So the bf16 decode is held to
# max(LM_TOL_STEPS, that distance) and the decode path itself at f32:
# decode vs forward of an f32 copy of the model within LM_SSM_F32_TOL, 4x
# the 4.8e-4 phase 14 measured at zamba2's widths (81 layers of f32 sums in
# other orders); a wrong position, state or conv slot moves logits by
# their own size
LM_SSM_F32_TOL = 2e-3
# phase 11: qwen2.5-14b at full width cut to 4 layers (16 B a parameter of
# bf16 params and grads, f32 master weights and moments: 42.5 GB at 4
# layers, 236 GB at 48), B 4 × S 512, 16 steps, a sketch merge every 8
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_MERGE = 4, 4, 512, 16, 8
# phase 12b: minicpm3-4b at its widths cut to 32 of 62 layers: 2.38·10^9
# parameters, 38 GB at 16 B a parameter (all 62 would need 68 GB before
# activations); phase 13b: qwen3-moe-30b-a3b cut to 4 of 48 layers: 3.11·10^9
# parameters, 49.8 GB (all 48 would need 489 GB). B 4 × S 512, 16 steps
LM_MLA_TRAIN_LAYERS, LM_MOE_TRAIN_LAYERS = 32, 4
# phase 14b: zamba2-7b cut to 24 of 81 layers, 4 whole periods of its shared
# block: 2.32·10^9 parameters, 37.1 GB at 16 B a parameter (all 81 would
# need 109 GB). The SSD scan needs every sequence it sees to be a multiple
# of its chunk (256 here, 16 in the smoke archs) or shorter than one
LM_HYBRID_TRAIN_LAYERS = 24
# phase 15: whisper-tiny served with phase 10's prompt and trained whole at
# its 448-token text context (1 500 frames a row); qwen2-vl-72b served at 32
# of 80 layers (3.06·10^10 parameters, 61.2 GB of bf16; all 80 would need
# 145 GB) with a 320-token prompt whose first 256 rows are the stub patch
# embeddings, and trained at 1 of 80 layers (3.37·10^9 parameters, 53.9 GB
# at 16 B a parameter; 2 layers would hold 67.9 GB before activations). The
# depths are reckoned from meta tensors against the card's memory before
# the phase runs (LM_SERVE_BUDGET, LM_TRAIN_BUDGET of the card's total)
LM_AUDIO_TRAIN_SEQ = 448
LM_VLM_PROMPT, LM_VLM_SERVE_LAYERS, LM_VLM_TRAIN_LAYERS = 320, 32, 1
LM_SERVE_BUDGET, LM_TRAIN_BUDGET = 0.85, 0.75
# 11c's tolerance on the resumed run's losses, relative: the resumed run
# starts from the same f32 tensors and runs the same kernels on the same
# shapes, so 0 is expected; a nondeterministic kernel (an atomic sum) would
# move a loss by a few f32 ulps
LM_RESUME_RTOL = 1e-6
# phase 16: the sharded steps on a (1, 1) mesh: 8 decode steps (one flush of
# the serving sketch: B tokens a chunk, 8 chunks a buffer) and 8 train steps
# (one flush of the token sketch: 2 048 tokens a step, a 2 048-id chunk, 8
# chunks a buffer)
LM_SHARDED_GEN, LM_SHARDED_TRAIN_STEPS = 8, 8
# phase 18: the train arms of the SSM, hybrid, audio and vlm families take
# phase 16's 8 steps (one flush of the token sketch)
LM_SHARDED_FAMILY_TRAIN_STEPS = 8
# phase 19: a) timed steps of each arm after one warm-up (8 steps in all: one
# flush of the token sketch, B tokens or 2 048 a chunk, 8 chunks a buffer);
# the qwen2.5-14b decode's counted bytes over phase 10's hand bound, at most
# (the count takes the embedding table whole, 1.56 GB of the 29.5, and
# every small op's operands and results); b) the dry-run cells and each
# one's limit
LM_DRYRUN_STEPS, LM_DRYRUN_BYTES_GAP = 7, 1.5
LM_DRYRUN_CELLS = (("mamba2-130m", "train_4k"), ("mamba2-130m", "prefill_32k"),
                   ("mamba2-130m", "decode_32k"), ("minicpm3-4b", "decode_32k"),
                   ("qwen2.5-14b", "prefill_32k"))
LM_DRYRUN_TIMEOUT = 300
# phase 20: the LM examples' subprocesses, each one's limit
EXAMPLES_TIMEOUT = 300


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def lm_dryrun_phase(dev, zero_counts, read_counts, kernel_plan) -> dict:
    """Phase 19 (module docstring): the line's fields; any failed check
    raises. ``zero_counts``/``read_counts`` are main's launch counters,
    ``kernel_plan`` the plan the sketches' ``auto`` resolves through."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as HA
    from repro_torch.launch.serve import SEQ_CACHES, pad_cache
    from repro_torch.models import model as M
    from repro_torch.plan import use_plan
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def counted(name, ms, ana):
        """The arm's fields; no timed step below its lower bound."""
        wire = sum(c["wire_bytes"] for c in ana["collectives"].values())
        terms = HA.roofline_terms(ana["flops"], ana["bytes"], wire)
        bound_ms = terms["step_lower_bound_s"] * 1e3
        if min(ms) < bound_ms:
            raise AssertionError(f"lm_dryrun {name}: a step of {min(ms)} ms beats its "
                                 f"bound {bound_ms} ms ({terms})")
        return {"flops": ana["flops"], "bytes": ana["bytes"], "wire_bytes": wire,
                "memory": ana["memory"], "roofline": terms, "step_ms": ms,
                "step_ms_mean": float(np.mean(ms)), "bound_ms": bound_ms,
                "step_over_bound": min(ms) / bound_ms}

    def decode_arm(name, cfg):
        """A 64-token prompt of B 4, then LM_DRYRUN_STEPS timed decode steps
        after a warm-up and one more under ``analyze``; the weights from
        phases 10's and 14c's seed."""
        b, p, n = LM_BATCH, LM_PROMPT, LM_DRYRUN_STEPS
        plan = ShardingPlan(cfg)
        model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        tokens = torch.from_numpy(TokenStream(cfg.vocab, b, p).next()["tokens"]).to(dev)
        with torch.no_grad():
            last, cache = S.make_prefill_step(cfg, plan)(model, {"tokens": tokens})
        cache = pad_cache(cache, p + n + 2)
        serve = S.make_serve_step(cfg, plan, device=dev)
        sketch = SK.init_token_sketch(cfg.sketch, 1, chunk=b, device=dev)
        nxt, ms = last.argmax(-1).to(torch.int32), []
        for i in range(n + 1):
            (nxt, cache, sketch), t = host_ms(
                lambda: serve(model, cache, nxt[:, None], p + i, sketch))
            ms.append(t)
        position = p + n + 1
        ana = HA.analyze(serve, model, cache, nxt[:, None], position, sketch)
        # phase 10's hand bound: every weight but the embedding table read
        # once, B rows of it, and the cache up to the position
        weights = sum(t.numel() * t.element_size() for t in model.parameters())
        row = model.embed.element_size() * cfg.d_model
        per_pos = sum(t.numel() * t.element_size()
                      for k, t in M.cache_shapes(cfg, b, 1).items() if k in SEQ_CACHES)
        hand = weights - row * cfg.vocab + row * b + per_pos * (position + 1)
        del model, cache, sketch
        torch.cuda.empty_cache()
        return {**counted(name, ms[1:], ana), "hand_bound_bytes": hand,
                "bytes_over_hand_bound": ana["bytes"] / hand, "position": position}

    t19 = time.perf_counter()
    zero_counts()
    with use_plan(kernel_plan):
        qwen = decode_arm("qwen2.5-14b decode", get_arch("qwen2.5-14b"))
        if not 1.0 <= qwen["bytes_over_hand_bound"] <= LM_DRYRUN_BYTES_GAP:
            raise AssertionError(f"lm_dryrun qwen2.5-14b decode: {qwen['bytes']} B counted "
                                 f"against a hand bound of {qwen['hand_bound_bytes']} B")
        mamba = get_arch("mamba2-130m")
        ssm_decode = decode_arm("mamba2-130m decode", mamba)
        # mamba2-130m's train step at phase 14c's B 4 × S 512
        plan = ShardingPlan(mamba)
        state = S.init_train_state(mamba, torch.Generator(device=dev).manual_seed(0), plan,
                                   device=dev)
        host = TokenStream(mamba.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ).next()
        batch = {k: torch.from_numpy(host[k]).to(dev) for k in ("tokens", "labels")}
        train = S.make_train_step(mamba, plan, device=dev)
        ms = []
        for _ in range(LM_DRYRUN_STEPS + 1):
            (state, _), t = host_ms(lambda: train(state, batch))
            ms.append(t)
        ssm_train = counted("mamba2-130m train", ms[1:], HA.analyze(train, state, batch))
        del state
        torch.cuda.empty_cache()
    launched = read_counts()
    if sum(launched.values()) < 3:
        raise AssertionError(f"lm_dryrun a): a flush an arm, launches {launched}")
    seconds_a = time.perf_counter() - t19

    # b) the dry run's cells, one subprocess each, all started together
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs, cells = {}, {}
    try:
        for arch, shape in LM_DRYRUN_CELLS:
            out = dryrun.RESULTS / f"{arch}__{shape}__single.json"
            for stale in (out, out.with_suffix(".error.json")):
                stale.unlink(missing_ok=True)
            procs[(arch, shape)] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", "single", "--auto"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for (arch, shape), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=LM_DRYRUN_TIMEOUT)
            out = dryrun.RESULTS / f"{arch}__{shape}__single.json"
            if proc.returncode != 0 or not out.exists():
                raise AssertionError(f"lm_dryrun {arch} × {shape}: exit {proc.returncode}: "
                                     f"{stdout[-1000:]} {stderr[-3000:]}")
            rec = json.loads(out.read_text())
            # the arch as the cell ran it: --auto's overrides (qwen2.5-14b's
            # q_head_pad adds a zero head a KV group) applied as lower_cell does
            cfg = dataclasses.replace(get_arch(arch), **{
                k: v for k, v in rec["cfg_overrides"].items() if k != "sketch_kernel"})
            if (rec["n_params"], rec["n_active_params"], rec["devices"]) != (
                    M.param_count(cfg), M.param_count(cfg, active_only=True), 256):
                raise AssertionError(f"lm_dryrun {arch} × {shape}: {rec['n_params']} params, "
                                     f"{rec['devices']} devices")
            cells[f"{arch}__{shape}"] = {
                k: rec[k] for k in ("kind", "flops_per_device", "bytes_per_device",
                                    "wire_bytes_per_device", "collectives", "memory",
                                    "model_flops_per_device", "useful_flops_ratio",
                                    "roofline", "lower_s", "compile_s", "cfg_overrides",
                                    "moe_strategy", "schedule", "n_params")}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"a_qwen_decode": qwen, "a_ssm_decode": ssm_decode, "a_ssm_train": ssm_train,
            "launches": launched, "seconds_a": seconds_a,
            "b_cells": cells, "seconds_b": time.perf_counter() - t0,
            "constants": {"peak_flops_bf16": HA.PEAK_FLOPS_BF16, "hbm_bw": HA.HBM_BW,
                          "link_bw": HA.LINK_BW}}


def examples_phase(kernel_plan, zero_counts, read_counts) -> dict:
    """Phase 20 (module docstring): the line's fields; any failed check
    raises. ``kernel_plan`` is the plan the card's ``auto`` resolves
    through; ``zero_counts``/``read_counts`` are main's launch counters."""
    import hashlib
    import os

    import numpy as np

    from repro_torch.data.synthetic import zipf_stream
    from repro_torch.examples import quickstart, stream_frequent_items
    from repro_torch.plan import use_plan

    def printed(main, device):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(["--device", device])
        return out.getvalue().splitlines()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-examples-") as tmp, \
            contextlib.chdir(tmp):
        try:
            for name, args in (("serve_decode", []),
                               ("train_lm_with_sketch", ["--ckpt-dir", f"{tmp}/ck"])):
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", f"repro_torch.examples.{name}", *args], cwd=tmp,
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            t0 = time.perf_counter()
            zero_counts()
            with use_plan(kernel_plan):
                on_card = {"quickstart": printed(quickstart.main, "cuda"),
                           "stream": printed(stream_frequent_items.main, "cuda")}
            launched = read_counts()
            seconds_card = time.perf_counter() - t0
            on_cpu = {"quickstart": printed(quickstart.main, "cpu"),
                      "stream": printed(stream_frequent_items.main, "cpu")}
            lm = {}
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=EXAMPLES_TIMEOUT)
                lm[name] = {"exit": proc.returncode, "tail": stdout.splitlines()[-3:],
                            "stderr_tail": stderr[-2000:] if proc.returncode else ""}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    if on_card["quickstart"] != on_cpu["quickstart"]:
        raise AssertionError(f"examples quickstart: card {on_card['quickstart']} "
                             f"against cpu {on_cpu['quickstart']}")
    # every line but the tier's describe(), which holds times
    if not on_card["stream"][-1].startswith("tier: {") \
            or on_card["stream"][:-1] != on_cpu["stream"][:-1]:
        raise AssertionError(f"examples stream: card {on_card['stream'][:-1]} "
                             f"against cpu {on_cpu['stream'][:-1]}")
    if not any("recall=1.00" in line for line in on_card["quickstart"]):
        raise AssertionError(f"examples quickstart: {on_card['quickstart']}")
    bad = {n: r for n, r in lm.items() if r["exit"] != 0}
    if bad:
        raise AssertionError(f"examples: {bad}")
    final = [line for line in lm["train_lm_with_sketch"]["tail"]
             if line.startswith("[sketch-final]")]
    if not final or "precision=1.000 recall=1.000" not in final[0]:
        raise AssertionError(f"examples train_lm_with_sketch: {lm['train_lm_with_sketch']}")
    if sum(launched.values()) == 0:
        raise AssertionError(f"examples: no kernel launched, {launched}")
    # quickstart's stream on this machine: its digest tells a machine whose
    # counts differ from another's by its numpy (tests/test_torch_examples.py
    # pins the digest of the machine the tests run on)
    stream = zipf_stream(500_000, skew=1.1, seed=0, max_id=10**6)
    return {"quickstart": on_card["quickstart"], "stream": on_card["stream"][:-1],
            "card_equals_cpu": True, "lm": lm, "launches": launched,
            "seconds_card_twins": seconds_card, "numpy": np.__version__,
            "quickstart_stream_sha256": hashlib.sha256(stream.tobytes()).hexdigest(),
            "quickstart_stream_item_1": int((stream == 1).sum())}


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
    from repro_torch.configs.registry import PAPER_STREAM_CONFIGS, get_arch, get_smoke_arch
    from repro_torch.core.exact import exact_counts
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import PlanOptions, ShardingPlan
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
        ss_ingest.INGEST_CLUSTER_LAUNCHES = ss_ingest.COMBINE_CLUSTER_LAUNCHES = 0
        ss_ingest.INGEST_WORKSPACE_LAUNCHES = ss_ingest.COMBINE_WORKSPACE_LAUNCHES = 0

    def read_counts():
        """Launches per kernel row; ``ss_combine_match_dense`` is the part of
        ``ss_combine_match`` that took the dense kernel, and the
        ``*_cluster`` and ``*_workspace`` counts the parts of the fused rows
        that took the cluster and workspace paths."""
        return {"ss_combine_match": ss_combine.LAUNCHES, "ss_query": ss_query.LAUNCHES,
                "ss_match": ss_match.LAUNCHES,
                "ss_fused_ingest": ss_ingest.INGEST_LAUNCHES,
                "ss_fused_combine": ss_ingest.COMBINE_LAUNCHES,
                "ss_combine_match_dense": ss_combine.DENSE_LAUNCHES,
                "ss_fused_ingest_cluster": ss_ingest.INGEST_CLUSTER_LAUNCHES,
                "ss_fused_combine_cluster": ss_ingest.COMBINE_CLUSTER_LAUNCHES,
                "ss_fused_ingest_workspace": ss_ingest.INGEST_WORKSPACE_LAUNCHES,
                "ss_fused_combine_workspace": ss_ingest.COMBINE_WORKSPACE_LAUNCHES}

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

    def fused_case(label, fn, plain, args, joined, reps, kernel, path=None):
        """One fused case; ``kernel`` names the row (``ss_fused_ingest`` or
        ``ss_fused_combine``), ``fn`` is its private wrapper with a ``path``
        (None: the rule's, which names the CUDA kernel whose device time is
        read and, on the cluster path, its size C). A case forced onto the
        workspace path at a shape the rule gives the cluster path also holds
        the cluster kernel's output bitwise the workspace kernel's."""
        b, k = args[0].shape
        w = args[3].shape[-1] if len(args) == 4 else 0
        rule = ss_ingest.path_for(k, w, b, args[1].dtype)
        path = path or rule
        device_kernel = kernel[3:] + ("" if path == "smem" else "_" + path) + "_kernel"
        got = fn(*args, path=path)
        torch.cuda.synchronize()
        err = compare(got, plain(*args))
        ms = time_ms(lambda: fn(*args, path=path), reps)
        dev_ms = device_ms(lambda: fn(*args, path=path), reps, device_kernel)
        plain_ms = time_ms(lambda: plain(*args), 3)
        b_ms, b_by = bound(nbytes(*args, *got), sum(valid(t) for t in joined))
        shape = {"B": b, "k": k}
        if len(args) == 4:
            shape["W"] = w
        before = (SMEM_MS_BEFORE[kernel].get(label)
                  or WORKSPACE_MS_BEFORE[kernel].get(label, (None, None)))
        case = {"case": label, "shape": shape, "dtype": str(args[1].dtype), "path": path,
                "max_abs_err": err, "ms": ms, "ms_before": before[0],
                "device_ms": dev_ms, "device_ms_before": before[1], "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}
        if path == "cluster":
            case["C"] = ss_ingest.cluster_for(k, w, b, args[1].dtype)
        if path == "workspace" and rule == "cluster":
            if compare(fn(*args), got) != 0:
                raise AssertionError(f"{label}: cluster output != workspace output")
            case["cluster_equals_workspace"] = True
        return case

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

    def ingest_case(label, s, win, reps=20, path=None):
        return fused_case(label, ss_ingest._fused_ingest, ref.fused_ingest_ref,
                          (*s, win), (s.items, win), reps, "ss_fused_ingest", path)

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

    # the shared-memory flush's hash table: the main path's state at zipf
    # 1.8, the fullest table (64 all-distinct windows at int64), ids that all
    # share one home slot of the public Fibonacci hash (x · 0x9E3779B1,
    # reduced by the high half of a product: x = y · 0x9E3779B1^-1 for y
    # below 2^32 / slots), 2 048 of them and W distinct ones, which the
    # table's keyed hash spreads; one id among EMPTYs
    ids18 = on_card(zipf_stream(TENANTS * 2 * window, 1.8, seed=1, max_id=MAX_ID)
                    .reshape(TENANTS, 2 * window))
    summ18 = Summary(*ops.ingest_window(*s0, ids18[:, :window], impl="sorted"))
    distinct64 = np.stack([rng.permutation(8 * K)[:window] for _ in range(TENANTS)])
    slots = ss_ingest.table_slots(window)
    chain = np.arange((2**32 - 1) // slots, dtype=np.uint64)
    chain = (chain * pow(0x9E3779B1, -1, 2**32)) & 0xFFFFFFFF
    chain = chain[(chain > MAX_ID) & (chain < 2**31 - 1)][:window]
    if len(chain) < window or (((chain * 0x9E3779B1) & 0xFFFFFFFF) * slots >> 32).any():
        raise AssertionError("the chain's ids do not share one home slot")
    chain = chain.astype(np.int32)
    chain_s = Summary(rows8.items.clone(), rows8.counts, rows8.errors)
    chain_s.items[1, :K // 2] = on_card(chain[:K // 2])
    chain_win = on_card(chain[rng.integers(0, K, (8, window))])
    chain_distinct = on_card(np.stack([rng.permutation(chain) for _ in range(8)]))
    one_id = np.full((8, window), EMPTY, np.int32)
    one_id[:, ::2] = 123457
    one_id[1, ::2] = int(rows8.items[1, 9])
    largest = (random_summary(2, 16384, 1.0, 1000, 1 << 20),
               on_card(np.stack([rng.permutation(1 << 24)[:131072]
                                 for _ in range(2)]).astype(np.int32)))
    edge_win = on_card(zipf_stream(TENANTS * (planned_w + 1), 1.1, seed=7, max_id=MAX_ID)
                       .reshape(TENANTS, planned_w + 1))
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
        ingest_case("flush_skew_1_8", summ18, ids18[:, window:].contiguous()),
        ingest_case("all_distinct_b64_int64", widened(summ), on_card(distinct64.astype(np.int32))),
        ingest_case("one_chain", chain_s, chain_win),
        ingest_case("chain_distinct", rows8, chain_distinct),
        ingest_case("one_id_and_empty", rows8, on_card(one_id)),
        ingest_case("k_1", Summary(*(a[:, :1].contiguous() for a in summ)), nxt),
        # above the shared-memory path's limits (the cluster path by the
        # rule, the workspace path where its clusters would take several
        # rounds of the card): the planned flush (the main summaries, a zipf
        # W 65 536 window a tenant), the paper's k above 2048 at B 8 and at
        # the sweep's B 64, the edge of 16-bit counts, both limits passed by
        # one, the largest pool; the planned flush and the largest pool also
        # forced onto the workspace kernel, the same inputs
        ingest_case("planned", summ, planned_ids, reps=10),
        ingest_case("planned_workspace", summ, planned_ids, reps=10, path="workspace"),
        ingest_case("planned_int64", widened(summ), planned_ids, reps=10),
        ingest_case("k_4000", random_summary(8, 4000, 1.0, 1000, 8 * 4000), nxt[:8].contiguous()),
        ingest_case("k_8000", random_summary(8, 8000, 1.0, 1000, 8 * 8000), nxt[:8].contiguous()),
        ingest_case("k_4000_b64", random_summary(TENANTS, 4000, 1.0, 1000, 8 * 4000), nxt),
        ingest_case("k_8000_b64", random_summary(TENANTS, 8000, 1.0, 1000, 8 * 8000), nxt),
        *(ingest_case(f"w_{w}", Summary(*(a[:2].contiguous() for a in summ)),
                      on_card(zipf_stream(2 * w, 1.1, seed=5, max_id=MAX_ID).reshape(2, w)))
          for w in (65535, 65536, 65537)),
        ingest_case("k_2049_w_16385", random_summary(2, 2049, 0.7, 1000, 8 * 2049),
                    on_card(zipf_stream(2 * 16385, 1.1, seed=6, max_id=MAX_ID)
                            .reshape(2, 16385))),
        ingest_case("largest_pool", *largest, reps=5),
        ingest_case("largest_pool_workspace", *largest, reps=5, path="workspace"),
        # where cluster_for changes C: at B 64 a W of C · 16 384 ids and one
        # more (C 2 → 4, 4 → 8), and at B 2 a k + W of 4 · 16 384 and one more
        # (C 8 → 16)
        *(ingest_case(f"edge_w_{w}", summ, planned_ids[:, :w].contiguous()
                      if w <= planned_w else edge_win, reps=5)
          for w in (32768, 32769, 65537)),
        *(ingest_case(f"edge_b2_w_{w}", Summary(*(a[:2].contiguous() for a in summ)),
                      planned_ids[:2, :w].contiguous(), reps=10)
          for w in (63488, 63489)),
    ]
    emit({"phase": "kernel", "kernel": "ss_fused_ingest", "cases": ingest_cases})
    # windows built to collide under the public hash cost the keyed table
    # no more than twice W random distinct ids (device time, B 8 each)
    dev_of = {c["case"]: c["device_ms"] for c in ingest_cases}
    for label in ("one_chain", "chain_distinct"):
        if None in (dev_of[label], dev_of["all_distinct"]) or \
                not dev_of[label] <= 2 * dev_of["all_distinct"]:
            raise AssertionError(f"ss_fused_ingest {label}: {dev_of[label]} ms device, above "
                                 f"twice all_distinct's {dev_of['all_distinct']}")

    def combine_round_case(label, a, b, reps=50):
        return fused_case(label, ss_ingest._fused_combine, ref.fused_combine_ref,
                          (*a, *b), (a.items, b.items), reps, "ss_fused_combine")

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
        # the workspace path: k above 2048, the paper's 4000 and 8000 among them
        *(combine_round_case(f"k_{k}", *(random_summary(8, k, fill, 1000, 2 * k)
                                         for fill in (1.0, 0.8)), reps=20)
          for k in (4000, 8000, 16384)),
        combine_round_case("k_8000_int64", *(widened(random_summary(8, 8000, fill, 1000, 16000))
                                             for fill in (1.0, 0.8)), reps=20),
        combine_round_case("k_8000_ties", *(random_summary(8, 8000, fill, 4, 16000)
                                            for fill in (1.0, 0.8)), reps=20),
        # the COMBINE tree's last rounds at k 8000: 4 pairs and 1
        *(combine_round_case(f"k_8000_b{b}", *(random_summary(b, 8000, fill, 1000, 16000)
                                                for fill in (1.0, 0.8)), reps=20)
          for b in (4, 1)),
    ]

    # the shared-memory COMBINE's hash join of s2's ids: the tree's last
    # rounds at k 2048 (4 pairs and 1 of the main state), disjoint and
    # identical ids, k 1, ids that all share one home slot of the public
    # Fibonacci hash in the join's table of join_slots(k) slots in both
    # summaries (built as the flush's chain ids are; held within twice
    # combine's device time: the table's hash is keyed by a salt drawn each
    # launch), and counts spread over 2^30 and 2^60 (the winners' 64- and
    # 128-bit keys)
    def pair_rows(s, hi):
        return Summary(*(a[:hi].contiguous() for a in s))

    def spread(s, hi, dtype):
        counts = on_card(rng.integers(0, hi, tuple(s.items.shape), dtype=np.int64))
        counts = torch.where(s.items != EMPTY, counts, 0).to(dtype)
        return Summary(s.items, counts, counts // 3)

    dis_a, dis_b = (random_summary(8, K, 1.0, 1000, 4 * K) for _ in range(2))
    dis_b = Summary(torch.where(dis_b.items != EMPTY, dis_b.items + 4 * K, EMPTY),
                    dis_b.counts, dis_b.errors)
    same_b = random_summary(8, K, 1.0, 1000, 4 * K)
    same_b = Summary(on_card(np.stack([rng.permutation(r) for r in dis_a.items.cpu().numpy()])),
                     same_b.counts, same_b.errors)
    join_slots = ss_ingest.join_slots(K)
    pair_chain = np.arange((2**32 - 1) // join_slots, dtype=np.uint64)
    pair_chain = (pair_chain * pow(0x9E3779B1, -1, 2**32)) & 0xFFFFFFFF
    pair_chain = pair_chain[(pair_chain > MAX_ID) & (pair_chain < 2**31 - 1)][:2 * K]
    if len(pair_chain) < 2 * K or \
            (((pair_chain * 0x9E3779B1) & 0xFFFFFFFF) * join_slots >> 32).any():
        raise AssertionError("the COMBINE chain's ids do not share one home slot")
    pair_chain = pair_chain.astype(np.int32)
    chain_a, chain_b = (
        Summary(on_card(np.stack([rng.permutation(pair_chain)[:K] for _ in range(8)])),
                x.counts, x.errors)
        for x in (random_summary(8, K, 1.0, 1000, 4 * K) for _ in range(2)))
    edge_pairs = {
        "tree_b4": (pair_rows(s1, 4), pair_rows(s2, 4)),
        "tree_b1": (pair_rows(s1, 1), pair_rows(s2, 1)),
        "disjoint": (dis_a, dis_b),
        "identical": (dis_a, same_b),
        "k_1": tuple(Summary(*(a[:, :1].contiguous() for a in x)) for x in (s1, s2)),
        "one_chain": (chain_a, chain_b),
        "wide_counts": (spread(dis_a, 2**30, torch.int32), spread(same_b, 2**30, torch.int32)),
        "huge_counts_int64": (spread(dis_a, 2**60, torch.int64),
                              spread(same_b, 2**60, torch.int64)),
    }
    fused_combine_cases += [combine_round_case(label, *pair)
                            for label, pair in edge_pairs.items()]
    # the result does not depend on the salt that keys the join's table:
    # the same inputs launched under two salts give the same bits
    salt_pairs = {"combine": (s1, s2), "ties": tuple(tie_pairs), **edge_pairs}
    for label, (a, b) in salt_pairs.items():
        outs = []
        for seed in (1, 2):
            ss_ingest._SALTS.seed(seed)
            outs.append(ss_ingest.fused_combine(*a, *b))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            raise AssertionError(f"ss_fused_combine {label}: two salts gave other bits")
    ss_ingest._SALTS.seed()                 # back to the operating system's entropy
    emit({"phase": "kernel", "kernel": "ss_fused_combine", "cases": fused_combine_cases,
          "salts_agree": sorted(salt_pairs), "seconds": time.perf_counter() - t_phase})
    comb_of = {c["case"]: c["device_ms"] for c in fused_combine_cases}
    if None in (comb_of["one_chain"], comb_of["combine"]) or \
            not comb_of["one_chain"] <= 2 * comb_of["combine"]:
        raise AssertionError(f"ss_fused_combine one_chain: {comb_of['one_chain']} ms device, "
                             f"above twice combine's {comb_of['combine']}")

    # the cluster kernels: ptxas's registers, stack and shared memory, and how
    # many clusters of each size the card runs at once at the planned flush
    # (k 2048, W 65 536) and at a COMBINE of k 8000
    cluster_ptxas, name = {}, None
    for ln in build.build_log("ss_ingest").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = None
            kernel = re.search(r"fused_(ingest|combine)_cluster_kernel", m.group(1))
            if kernel:
                name = kernel.group(0) + ("<int64>" if "IlE" in m.group(1) else "<int32>")
        elif name and ("Used" in ln or "spill" in ln):
            cluster_ptxas.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    occupancy = {
        f"{kernel}_{str(dtype)[6:]}": {
            c: ss_ingest.cluster_occupancy(kernel, dtype, k, w, c)
            for c in ss_ingest.CLUSTER_SIZES if ss_ingest.cluster_fits(k, w, c, dtype)}
        for kernel, k, w in (("ingest", K, planned_w), ("combine", 8000, 0))
        for dtype in (torch.int32, torch.int64)}
    smem_bytes = {  # all dynamic: ptxas reports none
        f"{kernel}_{str(dtype)[6:]}": {
            c: ss_ingest.cluster_smem_bytes(k, w or None, c, dtype)
            for c in ss_ingest.CLUSTER_SIZES if ss_ingest.cluster_fits(k, w, c, dtype)}
        for kernel, k, w in (("ingest", K, planned_w), ("combine", 8000, 0))
        for dtype in (torch.int32, torch.int64)}
    emit({"phase": "kernel", "kernel": "cluster_path", "ptxas": cluster_ptxas,
          "shared_memory_bytes": smem_bytes, "max_active_clusters": occupancy})

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
        if count <= 0 and name not in ("ss_match", "ss_combine_match_dense",
                                       "ss_fused_ingest_cluster", "ss_fused_combine_cluster",
                                       "ss_fused_ingest_workspace",
                                       "ss_fused_combine_workspace"):
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
    # takes the fused kernels there as the plan says (the cluster path at
    # W 65 536)
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
        planned_state = engine.ingest(engine.init(), blocks)
        torch.cuda.synchronize()
        planned_ingest_s = time.perf_counter() - t0
        planned_snap = engine.snapshot(planned_state)
        torch.cuda.synchronize()
        planned_s = time.perf_counter() - t0
        planned_launches = read_counts()
        planned_latency = latency("auto", planned.chunk, planned.buffer_depth, prefill=1)
    # the card's plan puts the flush on 'fused' at every probed k (phase 4):
    # its planned engine flushes W 65 536 through the cluster path, none
    # through the workspace path, and runs its COMBINE tree through the
    # fused COMBINE
    if not (flush_impl == "fused" and fused_tree
            and planned_launches["ss_fused_ingest_cluster"] > 0
            and planned_launches["ss_fused_ingest_workspace"] == 0
            and planned_launches["ss_fused_combine"] > 0):
        raise AssertionError(f"the planned engine at W {w_planned} did not launch the "
                             f"fused kernels: {flush_impl}, {planned_launches}")
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
          "ingest_items_per_s": blocks.numel() / planned_ingest_s,
          "items_per_s_before_workspace_path": PLANNED_ITEMS_PER_S_BEFORE,
          "items_per_s_workspace_path": PLANNED_ITEMS_PER_S_WORKSPACE,
          "launches": planned_launches, "snapshots_identical": True,
          "latency": planned_latency, "seconds": time.perf_counter() - t_phase})

    # the paper's k sweep under the measured plan: k 500..8000 at skew 1.1
    # over paper-default's 10^7 ids at the main geometry (W 16 384), each k
    # under sorted, fused and auto from the same stream: fused and auto
    # bitwise sorted, the guarantees against exact counts; k 4000 and 8000
    # flush through the cluster path
    t_phase = time.perf_counter()
    sweep_cfg = PAPER_STREAM_CONFIGS["paper-k-sweep"]
    sweep_stream = zipf_stream(PAPER_N, sweep_cfg["skew"], seed=0, max_id=MAX_ID)
    sweep_exact = exact_counts(sweep_stream)
    sweep_rows, sweep_cells = [], []
    for k in sweep_cfg["k_counters"]:
        truth = {i: c for i, c in sweep_exact.items() if c >= PAPER_N // k + 1}
        runs, launched = {}, {}
        for impl in ("sorted", "fused", "auto"):
            zero_counts()
            with use_plan(plan):
                runs[impl] = run_cell(n=PAPER_N, skew=sweep_cfg["skew"], k=k, impl=impl,
                                      tenants=TENANTS, buffer_depth=DEPTH, chunk=CHUNK,
                                      max_id=MAX_ID, device="cuda", stream=sweep_stream,
                                      oracle=(sweep_exact, truth))
            launched[impl] = read_counts()
        for impl in ("fused", "auto"):
            for a, b in zip(runs[impl][1].summary, runs["sorted"][1].summary):
                if not torch.equal(a, b):
                    raise AssertionError(f"paper k sweep k {k}: {impl} snapshot != sorted")
        path = ss_ingest.path_for(k, CHUNK * DEPTH, TENANTS, torch.int32)
        if k in (4000, 8000) and path != "cluster":
            raise AssertionError(f"paper k sweep k {k}: the flush's path is {path}")
        fused_runs = [i for i in ("fused", "auto")
                      if i == "fused" or plan.impl_for("flush", k) == "fused"]
        for impl in fused_runs:
            n = {p: launched[impl][f"ss_fused_ingest_{p}"] for p in ("cluster", "workspace")}
            if launched[impl]["ss_fused_ingest"] <= 0 or any(
                    (path == p) != (n[p] > 0) for p in n):
                raise AssertionError(f"paper k sweep k {k}: {impl} launched {launched[impl]}")
        cells = [runs[i][0] for i in runs]
        sweep_cells += cells
        sweep_rows.append({
            "k": k, "path": path, "flush_impl_auto": plan.impl_for("flush", k),
            "items_per_s": {i: PAPER_N / runs[i][0]["ingest_s"] for i in runs},
            "items_per_s_workspace_path": SWEEP_ITEMS_PER_S_WORKSPACE.get(k),
            **{m: {i: runs[i][0][m] for i in runs}
               for m in ("guaranteed_recall", "recall", "bound_violations")},
            "launches": launched})
    failures = check_record({"cells": sweep_cells})
    if failures:
        raise AssertionError("paper k sweep: " + "; ".join(failures))
    # one tune call at a shape above the shared-memory path's limits: the
    # flush surface at k 4096 × chunk 8192
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tune-k4096-") as tmp:
        big_argv = ["--device", "cuda", "--ops", "flush", "--k", "4096", "--chunks", "8192",
                    "--no-reductions", "--check", "--cache-dir", str(Path(tmp) / "plans"),
                    "--out", str(Path(tmp) / "plan_record.json")]
        log = io.StringIO()
        zero_counts()
        t_tune = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = tune.main(big_argv)
        big_tune = {"argv": big_argv, "exit": rc, "seconds": time.perf_counter() - t_tune,
                    "launches": read_counts()}
        if rc != 0:
            print(log.getvalue(), file=sys.stderr)
            raise AssertionError(f"tune {' '.join(big_argv)} exited {rc}")
        big_tune["flush_table"] = json.loads(
            (Path(tmp) / "plan_record.json").read_text())["plan"]["kernels"]["flush"]
    if big_tune["launches"]["ss_fused_ingest_cluster"] <= 0:
        raise AssertionError(f"tune at k 4096 launched no cluster flush: {big_tune}")
    emit({"phase": "paper_k_sweep", "card": card, "n": PAPER_N, "skew": sweep_cfg["skew"],
          "max_id": MAX_ID, "tenants": TENANTS, "chunk": CHUNK, "buffer_depth": DEPTH,
          "rows": sweep_rows, "snapshots_identical": True, "tune_k4096": big_tune,
          "seconds": time.perf_counter() - t_phase})

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

    def stream_batch(cfg, b, s):
        """The first TokenStream batch of B × ``s`` tokens with its extras
        (whisper's frames; qwen2-vl's patch embeddings and (3, B, S)
        positions), as numpy: run_serve's prompt draws the same extras."""
        data = TokenStream(cfg.vocab, b, s)
        host = data.next()
        host.update(data.extras(cfg))
        del host["labels"]
        return host

    def on_device(host, device, s=None):
        """A stream batch as tensors on ``device``, cut to its first ``s``
        positions (the tokens and the positions; the modality embeddings
        whole)."""
        out = {}
        for k, v in host.items():
            if s is not None and k == "tokens":
                v = v[:, :s]
            elif s is not None and k == "positions":
                v = v[:, :, :s]
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        return out

    def lm_serve_phase(lm_cfg, smoke_name, prompt_len=LM_PROMPT, keep=None):
        """Phases 10, 12a, 13a, 14a, 14c's and 15's serving (see the module
        docstring) on ``lm_cfg`` at full width: returns the JSON line's
        fields, each arm's kernel launches under ``arms``. ``keep`` (a dict)
        receives the auto arm's prompt, emitted tokens and last prefill
        logits."""
        from repro_torch.launch.serve import SEQ_CACHES, pad_cache
        from repro_torch.models import moe as moe_mod

        b, gen, every = LM_BATCH, LM_GEN, LM_REPORT_EVERY
        is_audio = lm_cfg.family == "audio"
        is_moe = lm_cfg.moe is not None
        is_ssm = lm_cfg.family in ("ssm", "hybrid")
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
        # counted below from this run's routing. The hybrid family's shared
        # block runs n_apps times a step (its 411 MB at zamba2's widths
        # stay far above the L2), so its weights count once per
        # application. An SSM's state and conv window keep their size: read
        # once and written once a step, whatever the position. Whisper's
        # decode step reads no encoder weight, and reads the cross
        # attention's ck/cv (n_frames positions) whole and writes none of it
        n_apps = lm_cfg.n_layers // lm_cfg.hybrid_attn_every \
            if lm_cfg.family == "hybrid" else 0
        shared_params = list(model.shared_attn.parameters()) if n_apps else []
        shared_bytes = nbytes(*shared_params)
        encoder_params = list(model.encoder.parameters()) if is_audio else []
        step_weight_bytes = param_bytes - nbytes(model.embed) - nbytes(*encoder_params) \
            + b * lm_cfg.d_model * model.embed.element_size() \
            + max(n_apps - 1, 0) * shared_bytes
        one_pos = M.cache_shapes(lm_cfg, b, 1)
        cache_bytes_per_pos = sum(nbytes(t) for n, t in one_pos.items() if n in SEQ_CACHES)
        cross_bytes = sum(nbytes(t) for n, t in one_pos.items() if n in ("ck", "cv"))
        state_bytes = sum(nbytes(t) for n, t in one_pos.items()
                          if n not in SEQ_CACHES and n not in ("ck", "cv"))
        cross_ops = (2 * b * lm_cfg.n_layers * lm_cfg.n_q_heads * 2 * lm_cfg.hd
                     * lm_cfg.enc_dec.n_frames if is_audio else 0)
        step_flops = 2 * b * (M.param_count(lm_cfg, active_only=True)
                              - sum(t.numel() for t in encoder_params)
                              + max(n_apps - 1, 0) * sum(t.numel() for t in shared_params)
                              + (0 if model.lm_head is None else model.lm_head.numel())) \
            + cross_ops
        # the matrix products run on bf16 tensor cores: each step's bound is
        # the larger of its bytes over the memory rate and its FLOPs over
        # the bf16 peak (the bytes, by far)
        ops_ms = step_flops / BF16_OPS_PER_S * 1e3
        bytes_ms = [(step_weight_bytes + 2 * state_bytes + cross_bytes
                     + cache_bytes_per_pos * (prompt_len + i + 1))
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
            if keep is not None and kernel == "auto":
                keep.update(prompt=out["prompt"], tokens=tokens,
                            prefill_logits=out["prefill_logits"])
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
        host = stream_batch(lm_cfg, b, prompt_len + forced)
        full_in, prompt_in = on_device(host, dev), on_device(host, dev, prompt_len)
        seq = full_in["tokens"]
        lm_plan = ShardingPlan(lm_cfg)
        routed, count_sums = [], []
        no_drop = lm_cfg if not is_moe else dataclasses.replace(
            lm_cfg, moe=dataclasses.replace(
                lm_cfg.moe, capacity_factor=lm_cfg.moe.n_experts / lm_cfg.moe.top_k))
        with torch.no_grad():
            full, _ = M.forward(model, full_in, no_drop)
            dropping = (M.forward(model, full_in, lm_cfg)[0][:, prompt_len:]
                        if is_moe else None)
            _, cache = S.make_prefill_step(lm_cfg, lm_plan)(model, prompt_in)
            cache = pad_cache(cache, prompt_len + forced)
            cache_shapes = {n: list(t.shape) for n, t in cache.items()}
            want = {n: list(t.shape) for n, t in
                    M.cache_shapes(lm_cfg, b, prompt_len + forced).items()}
            if cache_shapes != want:
                raise AssertionError(f"{name} serve a): cache {cache_shapes} != {want}")
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
        ssm_check = {}
        if is_ssm:
            # the same 72 tokens through an f32 copy of the model (TF32 off):
            # decode against the forward within LM_SSM_F32_TOL, and the bf16
            # forward's own distance from it, which bounds the bf16 check
            f32_cfg = dataclasses.replace(lm_cfg, param_dtype="float32",
                                          compute_dtype="float32")
            m32 = M.build_params(f32_cfg, dev)
            m32.load_state_dict({k: v.float() for k, v in params.items()})
            with torch.no_grad(), f32_matmuls():
                full32, _ = M.forward(m32, {"tokens": seq}, f32_cfg)
                _, c32 = S.make_prefill_step(f32_cfg, ShardingPlan(f32_cfg))(
                    m32, {"tokens": seq[:, :prompt_len]})
                c32 = pad_cache(c32, prompt_len + forced)
                errs32 = []
                for i in range(prompt_len, prompt_len + forced):
                    lg, c32, _ = M.decode_step(m32, c32, seq[:, i:i + 1], i, f32_cfg)
                    errs32.append(float((lg[:, 0] - full32[:, i]).abs().max()))
            rounding = float((full[:, prompt_len:] - full32[:, prompt_len:]).abs().max())
            del m32, c32, full32
            torch.cuda.empty_cache()
            if not max(errs32) <= LM_SSM_F32_TOL:
                raise AssertionError(f"{name} serve a): f32 decode vs forward {max(errs32)} "
                                     f"> {LM_SSM_F32_TOL}")
            tol = max(tol, rounding)
            ssm_check = {"bf16_forward_vs_f32_forward": rounding,
                         "tolerance_rule": "max(LM_TOL_STEPS x the largest logit, the bf16 "
                                           "forward's distance from the f32 forward)",
                         "f32": {"max_abs_err": max(errs32), "per_position": errs32,
                                 "tolerance": LM_SSM_F32_TOL}}
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
        if is_audio:
            family["encoder_decoder"] = {
                "encoder_layers": lm_cfg.enc_dec.n_enc_layers, "n_frames": lm_cfg.enc_dec.n_frames,
                "encoder_param_bytes": nbytes(*encoder_params),
                "cross_cache_shape": cache_shapes["ck"], "cross_cache_bytes": cross_bytes,
                "self_kv_per_position": cache_bytes_per_pos, "cross_ops": cross_ops,
                "note": "a decode step reads the decoder's weights once, ck/cv whole (not "
                        "padded, not written) and k/v up to its position; the encoder ran "
                        "once, in the prefill"}
        if lm_cfg.vlm is not None:
            family["vision"] = {
                "n_patches": lm_cfg.vlm.n_patches, "mrope_sections": list(lm_cfg.vlm.mrope_sections),
                "positions_shape": list(host["positions"].shape),
                "vision_embeds_shape": list(host["vision_embeds"].shape),
                "note": "prompt rows 0..n_patches-1 are the stub patch embeddings in the "
                        "forward and the prefill alike; decode is held at the positions "
                        "after the prompt"}
        if is_ssm:
            st = one_pos["ssm_state"]
            family["decode_bytes"] = {
                "weights_once": param_bytes - nbytes(model.embed)
                + b * lm_cfg.d_model * model.embed.element_size(),
                "shared_block": shared_bytes, "shared_applications": n_apps,
                "shared_rereads": max(n_apps - 1, 0) * shared_bytes,
                "ssm_state": nbytes(st), "ssm_state_dtype": str(st.dtype),
                "conv": nbytes(one_pos["conv"]), "state_read_and_written": 2 * state_bytes,
                "shared_kv_per_position": cache_bytes_per_pos,
                "note": "a step reads every weight once and the shared block once per "
                        "application, reads and writes the SSM state and conv window, "
                        "and reads the shared k/v up to its position"}
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
            # the prompt's modality inputs (the stream's first extras) with
            # the whole sequence's default positions
            extras = {k: v for k, v in stream_batch(smoke, b, both.shape[1]).items()
                      if k not in ("tokens", "positions")}
            counts, gaps, no_drop_errs = [], [], []       # the CPU's, then the card's
            with torch.no_grad():
                lg_cpu, _ = M.forward(cpu_model, {"tokens": both, **on_device(extras, "cpu")},
                                      smoke)
                lg_card, _ = M.forward(card_model, {"tokens": both.to(dev),
                                                    **on_device(extras, dev)}, smoke)
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
                step_weight_bytes + 2 * state_bytes + cross_bytes
                + cache_bytes_per_pos * (prompt_len + 2),
                step_weight_bytes + 2 * state_bytes + cross_bytes
                + cache_bytes_per_pos * (prompt_len + gen)],
            "arms": arms, **family,
            "decode_profile": {"device_busy_ms": busy_ms,
                               "kernels_per_step": sum(n for _, n in per_op.values()) / 3,
                               "top_ops": {key[:60]: {"ms": t / 3 / 1e3, "calls": n / 3}
                                           for key, (t, n) in top_ops}},
            "check_a_decode_vs_forward": {"positions": forced, "max_abs_err": max(errs),
                                          "per_position": errs, "max_abs_logit": top,
                                          "tolerance": None if is_moe else tol,
                                          "checked": not is_moe, "argmax_agree": agree,
                                          "argmax_of": b * forced, **ssm_check,
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
    kept10 = {}         # phase 16's references: no two full-width states at once
    lm = lm_serve_phase(get_arch("qwen2.5-14b"), "qwen2.5-14b", keep=kept10)
    lm_serve_launches = {arm: r["launches"] for arm, r in lm["arms"].items()}
    emit({"phase": "lm_serve", "card": card, **lm,
          "seconds": time.perf_counter() - t_phase})

    def lm_train_phase(full_cfg, layers, *, smoke_name, resume_arch=None,
                       smoke_lr=3e-4, seq=LM_TRAIN_SEQ, keep=None):
        """Phases 11, 12b–c, 13b–c, 14b, 14c's and 15's training (see the
        module docstring): ``full_cfg`` cut to ``layers`` layers, B 4 ×
        ``seq``; returns the JSON line's fields, the trainer's and the cuda
        engine's launches under ``launches``. ``keep`` (a dict) receives a)'s
        tokens, losses and grad norms."""
        from repro_torch.launch import train as train_cli
        from repro_torch.launch.train import run_train
        from repro_torch.optim import adamw

        cfg = dataclasses.replace(full_cfg, n_layers=layers)
        name = cfg.name
        is_moe = cfg.moe is not None
        b, steps = LM_TRAIN_BATCH, LM_TRAIN_STEPS
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
        if keep is not None:
            keep.update(tokens=tokens, losses=losses, grad_norms=gnorms,
                        expert_counts=out.get("expert_counts"))
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
        # size, the experts a token runs through; an SSM's depthwise conv
        # weight (d_conv, C) counts as one too, d_conv MACs a channel and a
        # token; the hybrid family's shared block once per application) at T
        # tokens, forward 2·N·T and backward 4·N·T, and causal attention (QK^T
        # and PV over the lower triangle, B·H·(d_qk + d_v)·S² a layer
        # forward, twice that backward; none in an SSM, n_apps layers of it
        # in the hybrid); full remat runs each layer's forward once more.
        # The SSD scan's f32 products (models/mamba2.py:ssd_scan: C·Bᵀ and
        # the decay-weighted product with dt·x over each Q×Q chunk, the
        # chunk states and the inter-chunk read-out) are f32 work outside
        # the tensor cores, bounded separately at the f32 peak. The
        # optimizer must read each bf16 grad and write each bf16 param
        # once, and read and write the f32 master, m and v: 28 B a parameter.
        # Whisper's encoder layers and its cross attention's k/v projections
        # run over the B·n_frames frame positions, not the B·S tokens; its
        # encoder attends over all F² pairs and its cross attention over
        # S·F, both non-causal.
        t = b * seq
        n_all = sum(p.numel() for p in named.values())
        n_head = cfg.d_model * cfg.vocab
        share = cfg.moe.top_k / cfg.moe.n_experts if is_moe else 1.0
        n_apps = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        n_layers = int(sum(p.numel() * (share if p.dim() == 3 else 1)
                           for pname, p in named.items()
                           if p.dim() in (2, 3) and pname.startswith("layers.")))
        n_layers += n_apps * sum(p.numel() for pname, p in named.items()
                                 if p.dim() == 2 and pname.startswith("shared_attn."))
        d_qk, d_v = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim)
                     if cfg.mla is not None else (cfg.hd, cfg.hd))
        att_layers = {"ssm": 0, "hybrid": n_apps}.get(cfg.family, cfg.n_layers)
        att_fwd = b * cfg.n_heads * (d_qk + d_v) * seq * seq * att_layers
        frame_flops = 0
        if cfg.family == "audio":
            f = cfg.enc_dec.n_frames
            cross_kv = sum(p.numel() for pname, p in named.items()
                           if pname.endswith(("cross_attn.wk", "cross_attn.wv")))
            n_enc = sum(p.numel() for pname, p in named.items()
                        if p.dim() == 2 and pname.startswith("encoder.layers."))
            n_layers -= cross_kv
            frame_flops = 2 * b * f * (n_enc + cross_kv)
            att_fwd += 2 * b * cfg.n_heads * (d_qk + d_v) * (
                cfg.enc_dec.n_enc_layers * f * f + cfg.n_layers * seq * f)
        ssd_fwd = 0
        if cfg.ssm is not None:
            sc = cfg.ssm
            q = min(sc.chunk, seq)
            nc, g, n_st, hp = seq // q, sc.n_groups, sc.d_state, sc.d_inner(cfg.d_model)
            ssd_fwd = cfg.n_layers * 2 * b * (nc * g * q * q * n_st      # C·Bᵀ a chunk
                                              + nc * q * q * hp          # with dt·x, (Q, Q) a head
                                              + 2 * seq * n_st * hp)     # states, read-out
        fwd = 2 * t * (n_layers + n_head) + frame_flops + att_fwd
        model_flops = 3 * fwd
        recompute_flops = fwd - 2 * t * n_head
        ssd_flops = 3 * ssd_fwd
        ssd_ms = ssd_flops / SCALAR_OPS_PER_S * 1e3
        opt_bytes = 28 * n_all
        timing = out["timings"]
        steady = slice(1, steps)
        step_ms = timing["step_ms"][steady]
        flops_ms = model_flops / BF16_OPS_PER_S * 1e3
        opt_bound_ms = opt_bytes / HBM_BYTES_PER_S * 1e3

        # one more step under the profiler (after the checks: it moves the state)
        train_step = S.make_train_step(cfg, ShardingPlan(cfg), device=dev,
                                       lr_fn=adamw.cosine_schedule(3e-4, 20, steps))
        data = TokenStream(cfg.vocab, b, seq)
        batch = data.next()
        batch.update(data.extras(cfg))
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
            "reduced": {"n_layers": [full_cfg.n_layers, layers]} if layers < full_cfg.n_layers
            else {},
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
            "ssd_f32_flops_per_step": ssd_flops, "ssd_bound_ms": ssd_ms,
            "ssd_bound_ms_with_recompute": (ssd_flops + ssd_fwd) / SCALAR_OPS_PER_S * 1e3,
            "step_bound_ms": flops_ms + opt_bound_ms + ssd_ms,
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
    kept11 = {}
    lm_train = lm_train_phase(get_arch("qwen2.5-14b"), LM_TRAIN_LAYERS,
                              smoke_name="qwen2.5-14b", resume_arch="qwen2.5-14b",
                              keep=kept11)
    lm_train_launches = {"auto": lm_train["launches"], "cuda": lm_train["cuda_engine_launches"]}
    emit({"phase": "lm_train", "card": card, **lm_train,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 12: the MLA family, minicpm3-4b, served whole and trained -----
    # at its widths cut to 32 of 62 layers; the smoke arch trained on the
    # card against the CPU
    t_phase = time.perf_counter()
    kept12, kept12t = {}, {}    # phase 17's references
    mla_serve = lm_serve_phase(get_arch("minicpm3-4b"), "minicpm3-4b", keep=kept12)
    lm_mla_serve_launches = {arm: r["launches"] for arm, r in mla_serve["arms"].items()}
    emit({"phase": "lm_mla_serve", "card": card, **mla_serve,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    mla_train = lm_train_phase(get_arch("minicpm3-4b"), LM_MLA_TRAIN_LAYERS,
                               smoke_name="minicpm3-4b", keep=kept12t)
    lm_mla_train_launches = {"auto": mla_train["launches"],
                             "cuda": mla_train["cuda_engine_launches"]}
    emit({"phase": "lm_mla_train", "card": card, **mla_train,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 13: the MoE family, qwen3-moe-30b-a3b, served whole and -------
    # trained at its widths cut to 4 of 48 layers, the expert sketch fed the
    # router's counts every step; main's crash and resume on mixtral's smoke
    # arch (MoE with a sliding window)
    t_phase = time.perf_counter()
    kept13, kept13t = {}, {}
    moe_serve = lm_serve_phase(get_arch("qwen3-moe-30b-a3b"), "qwen3-moe-30b-a3b",
                               keep=kept13)
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
                               smoke_lr=1e-6, keep=kept13t)
    if moe_train["max_memory_allocated"] > 75e9:
        raise AssertionError(f"lm_moe_train: peak {moe_train['max_memory_allocated']} "
                             f"> 75 GB at {LM_MOE_TRAIN_LAYERS} layers")
    lm_moe_train_launches = {"auto": moe_train["launches"],
                             "cuda": moe_train["cuda_engine_launches"]}
    emit({"phase": "lm_moe_train", "card": card, **moe_train,
          "seconds": time.perf_counter() - t_phase})

    # -- phase 14: the hybrid (zamba2-7b) and SSM (mamba2-130m) families -----
    # zamba2-7b served whole and trained at 24 of its 81 layers (4 periods of
    # the shared block); mamba2-130m served and trained whole, its smoke
    # arch crashed and resumed by main; the token sketch's kernels launched
    # on every path (ss_fused_ingest under auto, ss_combine_match under cuda)
    t_phase = time.perf_counter()
    t14 = t_phase

    def serve_kernels_launched(phase, line):
        arms = line["arms"]
        if arms["auto"]["launches"]["ss_fused_ingest"] < 1 \
                or arms["cuda"]["launches"]["ss_combine_match"] < 1:
            raise AssertionError(f"{phase}: launches {arms['auto']['launches']} / "
                                 f"{arms['cuda']['launches']}")

    kept14a, kept14b, kept14c, kept14ct = {}, {}, {}, {}   # phase 18's references
    hybrid_serve = lm_serve_phase(get_arch("zamba2-7b"), "zamba2-7b", keep=kept14a)
    serve_kernels_launched("lm_hybrid_serve", hybrid_serve)
    lm_hybrid_serve_launches = {arm: r["launches"] for arm, r in hybrid_serve["arms"].items()}
    emit({"phase": "lm_hybrid_serve", "card": card, **hybrid_serve,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    hybrid_train = lm_train_phase(get_arch("zamba2-7b"), LM_HYBRID_TRAIN_LAYERS,
                                  smoke_name="zamba2-7b", keep=kept14b)
    if hybrid_train["max_memory_allocated"] > 75e9:
        raise AssertionError(f"lm_hybrid_train: peak {hybrid_train['max_memory_allocated']} "
                             f"> 75 GB at {LM_HYBRID_TRAIN_LAYERS} layers")
    lm_hybrid_train_launches = {"auto": hybrid_train["launches"],
                                "cuda": hybrid_train["cuda_engine_launches"]}
    emit({"phase": "lm_hybrid_train", "card": card, **hybrid_train,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    ssm_serve = lm_serve_phase(get_arch("mamba2-130m"), "mamba2-130m", keep=kept14c)
    serve_kernels_launched("lm_ssm_serve", ssm_serve)
    lm_ssm_serve_launches = {arm: r["launches"] for arm, r in ssm_serve["arms"].items()}
    emit({"phase": "lm_ssm_serve", "card": card, **ssm_serve,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    mamba = get_arch("mamba2-130m")
    ssm_train = lm_train_phase(mamba, mamba.n_layers, smoke_name="mamba2-130m",
                               resume_arch="mamba2-130m", keep=kept14ct)
    lm_ssm_train_launches = {"auto": ssm_train["launches"],
                             "cuda": ssm_train["cuda_engine_launches"]}
    emit({"phase": "lm_ssm_train", "card": card, **ssm_train,
          "seconds": time.perf_counter() - t_phase})
    emit({"phase": "lm_ssm_hybrid", "seconds": time.perf_counter() - t14})

    # -- phase 15: the audio (whisper-tiny) and vlm (qwen2-vl-72b) families ----
    # whisper-tiny served and trained whole (encoder-decoder, cross attention,
    # the ck/cv cache), its smoke arch crashed and resumed by main;
    # qwen2-vl-72b at full width (M-RoPE, 256 stub patch embeddings) served
    # at 32 of 80 layers and trained at 1; the token sketch's kernels
    # launched on every path
    t15 = time.perf_counter()

    def reckoned_depth(cfg, layers, bytes_per_param, budget, what):
        """The largest depth ≤ ``layers`` whose parameters, at
        ``bytes_per_param``, fit ``budget`` of the card's memory (counted on
        the meta device); the reckoning, and the reason for any cut."""
        total = torch.cuda.mem_get_info()[1]
        need = lambda n: M.param_count(dataclasses.replace(cfg, n_layers=n),  # noqa: E731
                                       include_embed=True) * bytes_per_param
        depth = layers
        while depth > 1 and need(depth) > budget * total:
            depth -= 1
        out = {"what": what, "layers_asked": layers, "layers": depth,
               "full_layers": cfg.n_layers, "bytes": need(depth),
               "bytes_next": need(depth + 1) if depth < cfg.n_layers else None,
               "bytes_full": need(cfg.n_layers), "card_bytes": total, "budget": budget}
        if depth != layers:
            out["reason"] = (f"{layers} layers need {need(layers)} B > {budget} of the "
                             f"card's {total} B")
        emit({"phase": "lm_depth", "card": card, **out})
        return depth, out

    whisper = get_arch("whisper-tiny")
    t_phase = time.perf_counter()
    kept15a, kept15b, kept15c, kept15d = {}, {}, {}, {}   # phase 18's references
    audio_serve = lm_serve_phase(whisper, "whisper-tiny", keep=kept15a)
    serve_kernels_launched("lm_audio_serve", audio_serve)
    ck = audio_serve["encoder_decoder"]["cross_cache_shape"]
    if ck != [whisper.n_layers, LM_BATCH, whisper.enc_dec.n_frames, whisper.n_kv_heads,
              whisper.hd]:
        raise AssertionError(f"lm_audio_serve: ck of shape {ck}")
    lm_audio_serve_launches = {arm: r["launches"] for arm, r in audio_serve["arms"].items()}
    emit({"phase": "lm_audio_serve", "card": card, **audio_serve,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    audio_train = lm_train_phase(whisper, whisper.n_layers, smoke_name="whisper-tiny",
                                 resume_arch="whisper-tiny", seq=LM_AUDIO_TRAIN_SEQ,
                                 keep=kept15b)
    lm_audio_train_launches = {"auto": audio_train["launches"],
                               "cuda": audio_train["cuda_engine_launches"]}
    emit({"phase": "lm_audio_train", "card": card, **audio_train,
          "seconds": time.perf_counter() - t_phase})

    qwen_vl = get_arch("qwen2-vl-72b")
    t_phase = time.perf_counter()
    depth, serve_reckoning = reckoned_depth(qwen_vl, LM_VLM_SERVE_LAYERS, 2, LM_SERVE_BUDGET,
                                            "serve: bf16 weights")
    vlm_serve_layers = depth
    vlm_serve = lm_serve_phase(dataclasses.replace(qwen_vl, n_layers=depth), "qwen2-vl-72b",
                               prompt_len=LM_VLM_PROMPT, keep=kept15c)
    serve_kernels_launched("lm_vlm_serve", vlm_serve)
    if vlm_serve["vision"]["positions_shape"] != [3, LM_BATCH, LM_VLM_PROMPT + 8]:
        raise AssertionError(f"lm_vlm_serve: positions {vlm_serve['vision']}")
    lm_vlm_serve_launches = {arm: r["launches"] for arm, r in vlm_serve["arms"].items()}
    emit({"phase": "lm_vlm_serve", "card": card, **vlm_serve,
          "reduced": {"n_layers": [qwen_vl.n_layers, depth]}, "reckoning": serve_reckoning,
          "seconds": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    depth, train_reckoning = reckoned_depth(qwen_vl, LM_VLM_TRAIN_LAYERS, 16, LM_TRAIN_BUDGET,
                                            "train: bf16 params and grads, f32 master, m, v")
    vlm_train_layers = depth
    vlm_train = lm_train_phase(qwen_vl, depth, smoke_name="qwen2-vl-72b", keep=kept15d)
    if vlm_train["max_memory_allocated"] > 75e9:
        raise AssertionError(f"lm_vlm_train: peak {vlm_train['max_memory_allocated']} "
                             f"> 75 GB at {depth} layers")
    lm_vlm_train_launches = {"auto": vlm_train["launches"],
                             "cuda": vlm_train["cuda_engine_launches"]}
    emit({"phase": "lm_vlm_train", "card": card, **vlm_train, "reckoning": train_reckoning,
          "seconds": time.perf_counter() - t_phase})
    emit({"phase": "lm_audio_vlm", "card": card, "seconds": time.perf_counter() - t15})

    # -- phase 16: the sharded steps on a one-card mesh ------------------------
    # a world of 1 over nccl (a file rendezvous) and a (1, 1) data × model
    # DeviceMesh; qwen2.5-14b's state built on it one layer at a time
    # (train/steps.py:init_model, init_train_state) as DTensors placed by
    # its shardings, and the sharded prefill, serve and train steps
    # held against phases 10 and 11's own outputs from the same seed
    def sharded_serve(mesh, cfg, kept, ref, ref_phase, opts=None, prompt_len=LM_PROMPT):
        """16a, 17a–b, 18a–d: ``cfg`` from the seed of its serving phase
        ``ref_phase`` (10, 12a, 13a, 14a, 14c, 15a or 15c: ``kept`` holds
        that phase's prompt, tokens and last prefill logits, ``ref`` its
        line), the phase's prompt of ``prompt_len`` tokens with the
        stream's modality inputs (whisper's frames, qwen2-vl's patch
        embeddings and positions) placed by batch_shardings, the cache in
        cache_shardings at that phase's length, LM_SHARDED_GEN greedy decode
        steps with the token sketch under auto."""
        from torch.distributed.tensor import distribute_tensor
        label = f"lm_sharded {cfg.name} serve"
        opts = opts or PlanOptions()
        mplan = ShardingPlan(cfg, mesh, opts)
        b, gen = LM_BATCH, LM_SHARDED_GEN
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = S.init_model(cfg, mplan, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        first = model.layers[0]
        owner = first.mixer if hasattr(first, "mixer") else first.attn
        placed = {n: str(getattr(owner, n).placements)
                  for n in ("wq", "wdkv", "in_proj", "conv_w") if hasattr(owner, n)}
        if cfg.moe is not None:
            placed["w_gate"] = str(model.layers[0].moe.w_gate.placements)
        host = stream_batch(cfg, b, prompt_len)
        if not np.array_equal(host["tokens"], kept["prompt"]):
            raise AssertionError(f"{label}: not phase {ref_phase}'s prompt")
        pl = S.batch_shardings(cfg, mplan, {k: torch.from_numpy(v) for k, v in host.items()})
        inputs = {k: distribute_tensor(torch.from_numpy(v).to(dev), mesh, pl[k])
                  for k, v in host.items()}
        groups = S.sketch_groups(mplan)
        emitted, events, host_ms = [], [], []
        zero_counts()
        with use_plan(plan):        # the steps' engines resolve auto when built
            prefill = S.make_prefill_step(cfg, mplan)
            serve = S.make_serve_step(cfg, mplan, device=dev)
            last, cache = prefill(model, inputs)
            # the serving phase's cache length (its LM_GEN steps), so that
            # every decode attention reduces over the same positions
            cache = S.distribute_cache(cfg, mplan, cache, prompt_len + LM_GEN)
            sketch = SK.distribute_sketch(mplan, SK.init_token_sketch(
                cfg.sketch, groups, chunk=b // groups, device=dev))
            nxt = last.argmax(-1).to(torch.int32)
            for i in range(gen):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                nxt, cache, sketch = serve(model, cache, nxt[:, None], prompt_len + i, sketch)
                host_ms.append((time.perf_counter() - t0) * 1e3)
                end.record()
                events.append((start, end))
                emitted.append(nxt)
        launched = read_counts()
        torch.cuda.synchronize()
        step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
        got = torch.stack([t.full_tensor() for t in emitted], 1).cpu().numpy()
        if not np.array_equal(got, kept["tokens"][:, :gen]):
            raise AssertionError(f"{label}: tokens {got[0].tolist()} != phase {ref_phase}'s "
                                 f"{kept['tokens'][0, :gen].tolist()}")
        want = kept["prefill_logits"]
        gap = float((last.full_tensor().cpu() - want).abs().max())
        tol = LM_TOL_STEPS * float(want.abs().max())
        if not gap <= tol:
            raise AssertionError(f"{label}: last logits {gap} from phase {ref_phase}'s > {tol}")
        # the sketch: bitwise a sorted engine fed the same tokens in the same chunks
        ref_cfg = pin(cfg, "sorted")
        engine = SK.token_engine(ref_cfg.sketch, groups, device=dev)
        ref_sk = SK.init_token_sketch(ref_cfg.sketch, groups, chunk=b // groups, device=dev)
        for i in range(gen):
            ref_sk = SK.update_token_sketch(engine, ref_sk,
                                            torch.from_numpy(got[:, i:i + 1]).to(dev))
        mine = (*(t.full_tensor() for t in sketch.summary), sketch.buffer.full_tensor(),
                sketch.n.full_tensor())
        theirs = (*ref_sk.summary, ref_sk.buffer, ref_sk.n)
        if not all(torch.equal(x, y) for x, y in zip(mine, theirs)):
            raise AssertionError(f"{label}: the token sketch != sorted's")
        if launched["ss_fused_ingest"] < 1:
            raise AssertionError(f"{label}: launches {launched}")
        # one step without the sketch at the last position again, profiled
        with use_plan(plan):
            bare = S.make_serve_step(cfg, mplan, sketch_enabled=False, device=dev)
        per_op = profiled(lambda: bare(model, cache, nxt[:, None], prompt_len + gen - 1,
                                       sketch), 3)
        peak = torch.cuda.max_memory_allocated()
        del model, cache, sketch, last
        torch.cuda.empty_cache()
        ref_arm = ref["arms"]["auto"]
        tag = f"phase{ref_phase}"
        return {
            "arch": cfg.name, "moe_strategy": opts.moe_strategy, "batch": b,
            "prompt_len": prompt_len, "gen": gen, "init_s": init_s,
            **{f"{n}_placements": v for n, v in placed.items()},
            "cache_placements": {n: str(p) for n, p in S.cache_shardings(
                cfg, mplan, M.cache_shapes(cfg, b, prompt_len + LM_GEN)).items()},
            "decode_ms_per_step": float(np.mean(step_ms[1:])), "step_ms": step_ms,
            f"{tag}_decode_ms_per_step": ref_arm["decode_ms_per_step"],
            "step_host_ms_mean": float(np.mean(host_ms[1:])),
            f"{tag}_step_host_ms_mean": ref_arm["step_host_ms_mean"],
            "kernels_per_step": sum(n for _, n in per_op.values()) / 3,
            "device_busy_ms": sum(t_ for t_, _ in per_op.values()) / 3 / 1e3,
            f"{tag}_kernels_per_step": ref["decode_profile"]["kernels_per_step"],
            f"{tag}_device_busy_ms": ref["decode_profile"]["device_busy_ms"],
            f"tokens_equal_{tag}": True, "sample": got[0].tolist(),
            "last_logits_max_abs_err": gap, "last_logits_tolerance": tol,
            "last_logits_bitwise": gap == 0.0,
            "sketch": "bitwise a sorted engine fed the same tokens",
            "launches": launched, f"{tag}_launches": ref_arm["launches"],
            "max_memory_allocated": peak}

    def sharded_train(mesh, full_cfg, layers, kept, ref, ref_phase, opts=None,
                      seq=LM_TRAIN_SEQ, steps=LM_SHARDED_TRAIN_STEPS):
        """16b, 17c–d, 18e–h: the cut of train phase ``ref_phase`` (11, 12b,
        13b, 14b, 14c, 15b or 15d: ``full_cfg`` at ``layers`` layers, its
        seed, its batches of B × ``seq`` with the stream's modality inputs
        and its schedule; ``kept`` holds that phase's tokens, losses, grad
        norms and expert counts, ``ref`` its line), ``steps`` steps of the
        sharded train step. For MoE the expert counts of every step equal
        the phase's and the expert sketch is a sorted expert engine's fed
        them, bitwise."""
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.optim import adamw
        cfg = dataclasses.replace(full_cfg, n_layers=layers)
        label = f"lm_sharded {cfg.name} train"
        opts = opts or PlanOptions()
        mplan = ShardingPlan(cfg, mesh, opts)
        is_moe = cfg.moe is not None
        b = LM_TRAIN_BATCH
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = S.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), mplan,
                                   device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        data = TokenStream(cfg.vocab, b, seq, skew=1.1)
        losses, gnorms, seen, events, host_ms, counts = [], [], [], [], [], []
        zero_counts()
        with use_plan(plan):
            step = S.make_train_step(cfg, mplan, device=dev,
                                     lr_fn=adamw.cosine_schedule(3e-4, 20, LM_TRAIN_STEPS))
            for _ in range(steps):
                host = data.next()
                host.update(data.extras(cfg))       # as run_train draws them
                seen.append(host["tokens"].reshape(-1))
                pl = S.batch_shardings(cfg, mplan, {k: torch.from_numpy(v)
                                                    for k, v in host.items()})
                batch = {k: distribute_tensor(torch.from_numpy(v).to(dev), mesh, pl[k])
                         for k, v in host.items()}
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                host_ms.append((time.perf_counter() - t0) * 1e3)
                end.record()
                events.append((start, end))
                losses.append(metrics["loss"])
                gnorms.append(metrics["grad_norm"])
                if is_moe:
                    counts.append(metrics["expert_counts"].clone())
        launched = read_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
        losses = [float(x) for x in losses]
        gnorms = [float(x) for x in gnorms]
        tokens = np.stack(seen)
        tag = f"phase{ref_phase}"
        if not np.array_equal(tokens, kept["tokens"][:steps]):
            raise AssertionError(f"{label}: not phase {ref_phase}'s batches")
        loss_rel = max(abs(x / y - 1) for x, y in zip(losses, kept["losses"]))
        gnorm_rel = max(abs(x / y - 1) for x, y in zip(gnorms, kept["grad_norms"]))
        if not loss_rel <= 1e-6:
            raise AssertionError(f"{label}: losses {loss_rel} from phase {ref_phase}'s")
        # the phase's sketch after the same steps: its batches replayed through
        # a sorted engine (the train phase holds its trainer's sketch bitwise that)
        ref_cfg = pin(cfg, "sorted")
        engine = SK.token_engine(ref_cfg.sketch, 1, device=dev)
        ref_sk = SK.init_token_sketch(ref_cfg.sketch, 1, device=dev)
        for i in range(steps):
            ref_sk = SK.update_token_sketch(engine, ref_sk, torch.from_numpy(
                kept["tokens"][i].reshape(b, seq)).to(dev))
        sk = state.token_sketch
        mine = (*(t.full_tensor() for t in sk.summary), sk.buffer.full_tensor(),
                sk.n.full_tensor())
        if not all(torch.equal(x, y) for x, y in zip(mine, (*ref_sk.summary, ref_sk.buffer,
                                                             ref_sk.n))):
            raise AssertionError(f"{label}: the token sketch != phase {ref_phase}'s")
        if launched["ss_fused_ingest"] < 1:
            raise AssertionError(f"{label}: launches {launched}")
        moe_fields = {}
        if is_moe:
            # the global counts a step, plain: phase 13b's, bitwise; the
            # expert sketch a sorted expert engine's fed them; its
            # absorb_histogram launched ss_combine_match every step
            got_counts = torch.stack(counts).cpu().numpy()
            if not np.array_equal(got_counts, kept["expert_counts"][:steps]):
                raise AssertionError(f"{label}: expert counts != phase {ref_phase}'s")
            ref_exp = pin(cfg, "sorted").sketch
            exp_engine = SK.expert_engine(ref_exp, device=dev)
            ref_sk = SK.init_expert_sketch(ref_exp, device=dev)
            for row in kept["expert_counts"][:steps]:
                ref_sk = SK.update_expert_sketch(exp_engine, ref_sk,
                                                 torch.from_numpy(row).to(dev))
            if not all(np.array_equal(x, y) for x, y in zip(
                    state_to_numpy(state.expert_sketch), state_to_numpy(ref_sk))):
                raise AssertionError(f"{label}: the expert sketch != sorted's")
            if launched["ss_combine_match"] < steps:
                raise AssertionError(f"{label}: the expert sketch launched ss_combine_match "
                                     f"{launched['ss_combine_match']} times in {steps} steps")
            moe_fields = {"expert_counts_equal": True,
                          "expert_sketch": "bitwise a sorted expert engine fed phase "
                                           f"{ref_phase}'s counts",
                          "expert_counts_per_step": int(got_counts[0].sum())}
        del state, step, batch, sk
        torch.cuda.empty_cache()
        return {
            "arch": cfg.name, "moe_strategy": opts.moe_strategy, "layers": cfg.n_layers,
            "batch": b, "seq": seq, "steps": steps, "init_s": init_s,
            "reduced": {"n_layers": [full_cfg.n_layers, cfg.n_layers]},
            "losses": losses, "grad_norms": gnorms, f"loss_rel_vs_{tag}": loss_rel,
            "loss_tolerance": 1e-6, "losses_bitwise": loss_rel == 0.0,
            f"grad_norm_rel_vs_{tag}": gnorm_rel, **moe_fields,
            "step_ms_mean": float(np.mean(step_ms[1:])), "step_ms": step_ms,
            f"{tag}_step_ms_mean": ref["step_ms_mean"],
            "step_host_ms_mean": float(np.mean(host_ms[1:])),
            f"{tag}_step_host_ms_mean": ref["step_host_ms_mean"],
            "sketch": f"bitwise phase {ref_phase}'s batches through a sorted engine",
            "launches": launched, f"{tag}_launches": ref["launches"],
            "max_memory_allocated": peak}

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    t_phase = time.perf_counter()
    if not dist.is_nccl_available():
        raise AssertionError("lm_sharded: torch has no nccl")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                                world_size=1)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"lm_sharded: backend {dist.get_backend()}")
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            t16 = time.perf_counter()
            sharded = {"serve": sharded_serve(mesh, get_arch("qwen2.5-14b"), kept10, lm, 10)}
            sharded["serve"]["seconds"] = time.perf_counter() - t16
            t16 = time.perf_counter()
            sharded["train"] = sharded_train(mesh, get_arch("qwen2.5-14b"), LM_TRAIN_LAYERS,
                                             kept11, lm_train, 11)
            sharded["train"]["seconds"] = time.perf_counter() - t16
            lm_sharded_launches = {"serve": sharded["serve"]["launches"],
                                   "train": sharded["train"]["launches"]}
            emit({"phase": "lm_sharded", "card": card, "backend": "nccl", "mesh": [1, 1],
                  "mesh_dims": ["data", "model"], **sharded,
                  "seconds": time.perf_counter() - t_phase})

            # -- phase 17: the MLA and MoE families on the one-card mesh -------
            # minicpm3-4b and qwen3-moe-30b-a3b (under moe_strategy "ep", the
            # dry run's --auto choice) served whole and trained at phases 12b
            # and 13b's cuts, against phases 12 and 13's outputs from the same
            # seed; one full-width state resident at a time
            t17 = time.perf_counter()
            ep = PlanOptions(moe_strategy="ep")
            families = {}
            for arm, run in (
                    ("a_mla_serve", lambda: sharded_serve(
                        mesh, get_arch("minicpm3-4b"), kept12, mla_serve, "12a")),
                    ("b_moe_serve", lambda: sharded_serve(
                        mesh, get_arch("qwen3-moe-30b-a3b"), kept13, moe_serve, "13a", ep)),
                    ("c_moe_train", lambda: sharded_train(
                        mesh, get_arch("qwen3-moe-30b-a3b"), LM_MOE_TRAIN_LAYERS, kept13t,
                        moe_train, "13b", ep)),
                    ("d_mla_train", lambda: sharded_train(
                        mesh, get_arch("minicpm3-4b"), LM_MLA_TRAIN_LAYERS, kept12t,
                        mla_train, "12b"))):
                t_arm = time.perf_counter()
                families[arm] = run()
                families[arm]["seconds"] = time.perf_counter() - t_arm
            lm_sharded_family_launches = {arm: r["launches"] for arm, r in families.items()}
            emit({"phase": "lm_sharded_families", "card": card, "backend": "nccl",
                  "mesh": [1, 1], "mesh_dims": ["data", "model"], **families,
                  "note": "on a (1, 1) mesh moe_strategy tp and ep place every tensor "
                          "alike; mixtral-8x7b (93 GB of bf16) and every mesh dim above 1 "
                          "run only in the gloo tests (written, not run across cards)",
                  "seconds": time.perf_counter() - t17})

            # -- phase 18: the SSM, hybrid, audio and vlm families on the mesh --
            # mamba2-130m, zamba2-7b and whisper-tiny served whole and
            # qwen2-vl-72b at phase 15c's depth; each trained at its train
            # phase's cut (zamba2-7b at 24 layers, qwen2-vl-72b at 1, whisper
            # at its 448-token context), against phases 14 and 15's outputs
            # from the same seeds; one full-width state resident at a time
            t18 = time.perf_counter()
            families18 = {}
            for arm, run in (
                    ("a_ssm_serve", lambda: sharded_serve(
                        mesh, get_arch("mamba2-130m"), kept14c, ssm_serve, "14c")),
                    ("b_hybrid_serve", lambda: sharded_serve(
                        mesh, get_arch("zamba2-7b"), kept14a, hybrid_serve, "14a")),
                    ("c_audio_serve", lambda: sharded_serve(
                        mesh, whisper, kept15a, audio_serve, "15a")),
                    ("d_vlm_serve", lambda: sharded_serve(
                        mesh, dataclasses.replace(qwen_vl, n_layers=vlm_serve_layers), kept15c,
                        vlm_serve, "15c", prompt_len=LM_VLM_PROMPT)),
                    ("e_hybrid_train", lambda: sharded_train(
                        mesh, get_arch("zamba2-7b"), LM_HYBRID_TRAIN_LAYERS, kept14b,
                        hybrid_train, "14b", steps=LM_SHARDED_FAMILY_TRAIN_STEPS)),
                    ("f_ssm_train", lambda: sharded_train(
                        mesh, mamba, mamba.n_layers, kept14ct, ssm_train, "14c",
                        steps=LM_SHARDED_FAMILY_TRAIN_STEPS)),
                    ("g_audio_train", lambda: sharded_train(
                        mesh, whisper, whisper.n_layers, kept15b, audio_train, "15b",
                        seq=LM_AUDIO_TRAIN_SEQ, steps=LM_SHARDED_FAMILY_TRAIN_STEPS)),
                    ("h_vlm_train", lambda: sharded_train(
                        mesh, qwen_vl, vlm_train_layers, kept15d, vlm_train, "15d",
                        steps=LM_SHARDED_FAMILY_TRAIN_STEPS))):
                t_arm = time.perf_counter()
                families18[arm] = run()
                families18[arm]["seconds"] = time.perf_counter() - t_arm
            lm_sharded_family_launches.update(
                {arm: r["launches"] for arm, r in families18.items()})
            emit({"phase": "lm_sharded_rest", "card": card, "backend": "nccl",
                  "mesh": [1, 1], "mesh_dims": ["data", "model"], **families18,
                  "train_steps": LM_SHARDED_FAMILY_TRAIN_STEPS,
                  "note": "every family on the mesh; model and data dims above 1 run "
                          "only in the gloo tests (written, not run across cards)",
                  "seconds": time.perf_counter() - t18})
        finally:
            dist.destroy_process_group()

    # -- phase 19: the dry run's cost analysis -----------------------------------
    t_phase = time.perf_counter()
    dry = lm_dryrun_phase(dev, zero_counts, read_counts, plan)
    lm_dryrun_launches = dry["launches"]
    emit({"phase": "lm_dryrun", "card": card, **dry,
          "phase10_decode_bound_ms": lm["decode_bound_ms"],
          "seconds": time.perf_counter() - t_phase})

    # -- phase 20: the examples ---------------------------------------------------
    t_phase = time.perf_counter()
    examples = examples_phase(plan, zero_counts, read_counts)
    examples_launches = examples["launches"]
    emit({"phase": "examples", "card": card, **examples,
          "seconds": time.perf_counter() - t_phase})

    # -- the contract lines ---------------------------------------------------
    def measured(case):
        """A case without the times of earlier runs (``*_before``), which
        the phase lines print: the kernels line holds this run's numbers."""
        return {key: v for key, v in case.items() if not key.endswith("_before")}

    def row(name, source, replaces, cases, path="main"):
        head = cases[0]
        extra = {key: head[key] for key in ("dense_compare_ms",) if key in head}
        counts = tune_launches if path == "tune" else launches
        count = counts[name]
        if name == "ss_combine_match":
            extra["dense_launches"] = counts["ss_combine_match_dense"]
        if name in ("ss_fused_ingest", "ss_fused_combine"):
            extra["cluster_launches"] = counts[f"{name}_cluster"]
            extra["workspace_launches"] = counts[f"{name}_workspace"]
            extra["planned_launches"] = planned_launches[name]
            extra["planned_cluster_launches"] = planned_launches[f"{name}_cluster"]
            extra["planned_workspace_launches"] = planned_launches[f"{name}_workspace"]
            extra["paper_k_sweep_launches"] = {
                f"k{r['k']}_{impl}": r["launches"][impl][name]
                for r in sweep_rows for impl in r["launches"]}
            extra["paper_k_sweep_cluster_launches"] = {
                f"k{r['k']}_{impl}": r["launches"][impl][f"{name}_cluster"]
                for r in sweep_rows for impl in r["launches"]}
            extra["cluster_cases"] = [
                {key: c[key] for key in ("case", "shape", "dtype", "C", "device_ms")}
                for c in cases if c["path"] == "cluster"]
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
                "lm_hybrid_serve_launches": lm_hybrid_serve_launches["auto"][name],
                "lm_hybrid_serve_cuda_launches": lm_hybrid_serve_launches["cuda"][name],
                "lm_hybrid_train_launches": lm_hybrid_train_launches["auto"][name],
                "lm_hybrid_train_cuda_launches": lm_hybrid_train_launches["cuda"][name],
                "lm_ssm_serve_launches": lm_ssm_serve_launches["auto"][name],
                "lm_ssm_serve_cuda_launches": lm_ssm_serve_launches["cuda"][name],
                "lm_ssm_train_launches": lm_ssm_train_launches["auto"][name],
                "lm_ssm_train_cuda_launches": lm_ssm_train_launches["cuda"][name],
                "lm_audio_serve_launches": lm_audio_serve_launches["auto"][name],
                "lm_audio_serve_cuda_launches": lm_audio_serve_launches["cuda"][name],
                "lm_audio_train_launches": lm_audio_train_launches["auto"][name],
                "lm_audio_train_cuda_launches": lm_audio_train_launches["cuda"][name],
                "lm_vlm_serve_launches": lm_vlm_serve_launches["auto"][name],
                "lm_vlm_serve_cuda_launches": lm_vlm_serve_launches["cuda"][name],
                "lm_vlm_train_launches": lm_vlm_train_launches["auto"][name],
                "lm_vlm_train_cuda_launches": lm_vlm_train_launches["cuda"][name],
                "lm_sharded_serve_launches": lm_sharded_launches["serve"][name],
                "lm_sharded_train_launches": lm_sharded_launches["train"][name],
                **{f"lm_sharded_{arm[2:]}_launches": counts_[name]
                   for arm, counts_ in lm_sharded_family_launches.items()},
                "lm_dryrun_launches": lm_dryrun_launches[name],
                "examples_launches": examples_launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases), "tolerance": 0,
                "ms": head["ms"], "device_ms": head["device_ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], **extra,
                "library_ms": None,
                "library_note": "no single PyTorch call computes this function",
                "shape": head["shape"], "cases": [measured(c) for c in cases]}

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
