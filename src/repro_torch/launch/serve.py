"""Serving driver: batched prefill → greedy decode loop with hot-token telemetry.

The counterpart of ``repro.launch.serve``, on the families the port's
model runs: dense GQA, MLA and MoE (``--arch`` defaults to qwen2.5-14b).
The Space Saving sketch rides along as serving telemetry through the
StreamRuntime: every decode step feeds its B emitted tokens into the
engine's buffered update path (``train/steps.py:make_serve_step``; merges amortized over
``buffer_depth`` chunks). ``--report-every`` publishes an immutable
snapshot into a :class:`SnapshotRing` (``RingPublisher`` — the ingest
buffer is NOT flushed; decode keeps appending to it) and answers hot-token
queries through the ring's :class:`ServeFrontend`: top-n plus the
guarantee-split k-majority report.

Telemetry goes through the obs layer: spans around prefill, decode and each
report tick on the process tracer, ``[name] key=value`` lines, the
histogram ``serve.decode.step_s`` (host time of each step's dispatch) and
the counter ``serve.decode.tokens`` in the process registry.
``--metrics-dump`` prints the registry and the trace-event tail as JSON.

The work is :func:`run_serve`, which returns the emitted tokens, the final
sketch, the reports and the timings. Entry points run on the card unless
``--device cpu`` asks for the CPU; without a card, ``--device cuda`` raises.

  python -m repro_torch.launch.serve --device cpu --arch qwen2.5-14b --smoke \\
      --batch 2 --prompt-len 32 --gen 12 --report-every 4 --metrics-dump
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_arch, get_smoke_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import model as M
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import RingPublisher, ServeFrontend, SnapshotRing
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK
from repro_torch.train import steps as S


class _Stopwatch:
    """Host seconds of each timed block (``time()`` as an obs Histogram's)."""

    def __init__(self):
        self.samples: list[float] = []

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.append(time.perf_counter() - t0)


def _card_event(on_card: bool):
    if not on_card:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def pad_seq(c: torch.Tensor, max_len: int) -> torch.Tensor:
    """A prompt-sized cache tensor (L, B, S, ...) padded with zeros on its
    sequence axis (2) out to ``max_len``, whatever its rank: GQA's k/v
    (L, B, S, KV, hd), MLA's c_kv and k_rope (L, B, S, r)."""
    return F.pad(c, (0, 0) * (c.dim() - 3) + (0, max_len - c.shape[2]))


def run_serve(cfg, *, batch: int = 4, prompt_len: int = 64, gen: int = 64,
              report_every: int = 32, k_majority: int = 16, seed: int = 0,
              device="cuda", model=None) -> dict:
    """Prefill a TokenStream prompt, decode ``gen`` greedy steps with the
    token sketch, and publish a hot-token report every ``report_every``.

    ``model`` (a :class:`~repro_torch.models.model.DenseLM` on ``device``)
    defaults to fresh weights from ``torch.Generator(device)`` seeded with
    ``seed``. On a card, ``timings`` holds CUDA-event times of the prefill
    and of each decode step; on the CPU those are None.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_serve: no CUDA card is available; pass device='cpu'")
    on_card = device.type == "cuda"
    T = obs_trace.DEFAULT
    reg = obs_metrics.DEFAULT
    m_step = reg.histogram("serve.decode.step_s")   # per-step host dispatch
    m_tokens = reg.counter("serve.decode.tokens")

    plan = ShardingPlan(cfg, None)
    max_len = prompt_len + gen
    if model is None:
        model = M.init_params(cfg, torch.Generator(device).manual_seed(seed), device)
    sketch_watch = _Stopwatch()
    prefill = S.make_prefill_step(cfg, plan)
    serve = S.make_serve_step(cfg, plan, device=device, sketch_timer=sketch_watch)

    data = TokenStream(cfg.vocab, batch, prompt_len)
    prompt = data.next()["tokens"]
    inputs = {"tokens": torch.from_numpy(prompt).to(device)}

    t0 = time.perf_counter()
    with T.span("serve.prefill", batch=batch, prompt_len=prompt_len):
        e0 = _card_event(on_card)
        last_logits, cache = prefill(model, inputs)
        cache = {name: pad_seq(c, max_len) for name, c in cache.items()}
        e1 = _card_event(on_card)
    T.log("serve.prefill.done", batch=batch, prompt_len=prompt_len,
          elapsed_s=time.perf_counter() - t0)

    # one group on one process (make_serve_step's engine has the same);
    # chunk = the decode payload (B tokens a step), so buffer slots hold
    # real tokens, not EMPTY padding up to the training chunk
    groups = S.sketch_groups(plan)
    runtime = SK.token_runtime(cfg.sketch, groups, chunk=max(1, batch // groups),
                               device=device)
    sketch = runtime.init()
    ring = SnapshotRing()
    publisher = RingPublisher(runtime, ring)
    telemetry = ServeFrontend(ring, runtime.frontend())
    tokens = last_logits.argmax(-1).to(torch.int32)[:, None]
    emitted, step_host_s, step_events, reports = [], [], [], []
    t0 = time.perf_counter()
    with T.span("serve.decode", gen=gen, batch=batch):
        for i in range(gen):
            pos = prompt_len + i
            start = _card_event(on_card)
            t_step = time.perf_counter()
            tokens_next, cache, sketch = serve(model, cache, tokens, pos, sketch)
            step_host_s.append(time.perf_counter() - t_step)
            m_step.record(step_host_s[-1])
            step_events.append((start, _card_event(on_card)))
            m_tokens.inc(batch)
            emitted.append(tokens_next)      # one host transfer after the loop
            tokens = tokens_next[:, None]
            if (i + 1) % report_every == 0:
                with T.span("serve.report", step=i + 1):
                    snap = publisher.publish(sketch)
                    hot = telemetry.top_table(5)
                    rep = telemetry.k_majority_report(k_majority)
                T.log("serve.hot_tokens", step=i + 1, version=snap.version, n=int(hot.n),
                      top=",".join(f"{r['item']}:{r['count']}" for r in hot.rows),
                      k_majority=k_majority, guaranteed=int(rep.guaranteed_items.size),
                      candidate=int(rep.unconfirmed_items.size))
                reports.append({"step": i + 1, "version": snap.version, "n": int(hot.n),
                                "top": hot.rows,
                                "guaranteed": rep.guaranteed_items.tolist(),
                                "candidate": rep.unconfirmed_items.tolist()})
    sample = torch.stack(emitted, 1).cpu().numpy()     # the one host transfer
    if on_card:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    T.log("serve.decode.done", gen=gen, batch=batch, elapsed_s=dt,
          tok_per_s=gen * batch / dt)
    T.log("serve.sample", tokens=str(sample[0][:16].tolist()))

    step_ms = [s.elapsed_time(e) for s, e in step_events] if on_card else None
    timings = {
        "prefill_ms": e0.elapsed_time(e1) if on_card else None,
        "step_ms": step_ms,
        # after one warm-up step
        "decode_ms_per_step": (sum(step_ms[1:]) / (gen - 1)
                               if on_card and gen > 1 else None),
        "step_host_s": step_host_s,
        "sketch_host_s": sketch_watch.samples,
        "decode_s": dt,
        "tok_per_s": gen * batch / dt,
    }
    return {"arch": cfg.name, "device": str(device), "batch": batch,
            "prompt_len": prompt_len, "gen": gen, "prompt": prompt, "tokens": sample,
            "prefill_logits": last_logits.cpu(), "sketch": sketch, "runtime": runtime,
            "reports": reports, "timings": timings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b",
                    help="a dense GQA arch (qwen2.5-14b, yi-34b, qwen1.5-110b), "
                         "MLA (minicpm3-4b) or MoE (qwen3-moe-30b-a3b, mixtral-8x7b)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--report-every", type=int, default=32)
    ap.add_argument("--k-majority", type=int, default=16,
                    help="k for the guarantee-split frequent-token report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the cache and the sketch live")
    ap.add_argument("--metrics-dump", action="store_true",
                    help="print the process metrics registry + trace "
                         "tail as JSON on exit")
    args = ap.parse_args(argv)

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    run_serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
              report_every=args.report_every, k_majority=args.k_majority,
              seed=args.seed, device=args.device)
    if args.metrics_dump:
        print(json.dumps({"metrics": obs_metrics.DEFAULT.describe(),
                          "events": obs_trace.DEFAULT.events()[-64:]}, indent=2,
                         default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
