"""Where one decode step of the LM serving path spends its time.

    PYTHONPATH=src python tools/decode_times.py [--arch qwen2.5-14b] [--smoke]
        [--batch 4] [--prompt-len 64] [--steps 16] [--reps 20] [--device cuda]
        [--trace-dir DIR]

At ``chip_smoke.py`` phase 10's geometry by default (qwen2.5-14b at full
width, bf16, seeded weights made on the device, B 4, a 64-token
``TokenStream`` prompt), after a prefill:

* the host clock of ``--steps`` serve steps (``train/steps.make_serve_step``,
  sketch under ``cuda``; ``sorted`` on the CPU), with the token sketch and
  without it, and the wall clock of one step ended by a device sync;
* the host clock of each public piece of one decode step, each called
  alone at the step's shapes after a device sync, so the clock reads the
  enqueue and not the device (median of ``--reps``): the embedding, per
  layer the two norms, ``project_qkv``, ``apply_rope`` of q and of k,
  ``decode_attention_plus_one``, the output projection, the MLP and the
  residual adds, then the cache write and the head; the per-layer pieces
  times the layer count, beside the step;
* one decode step under ``torch.profiler`` (CPU and CUDA): the ATen ops and
  kernel launches a step, the host time of the CUDA launch calls, the
  device busy time (the union of kernel intervals) against the step's
  span, and the host ops that cost the most.

Prints one JSON line, then the card's name and power limit (on a card).
On the CPU (``--device cpu``, with ``--smoke``) it runs as a rehearsal and
prints no device number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from feed_times import union


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, device, reps):
    """Median host ms of ``fn`` called after a device sync (its enqueue)."""
    fn()
    samples = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    _sync(device)
    return float(np.median(samples))


def pieces(model, cache, cfg, tokens, position, device, reps):
    """Host ms of each public piece of one decode step at its shapes."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import mm
    from repro_torch.models.rope import apply_rope
    import torch.nn.functional as F

    block = model.layers[0]
    x = F.embedding(tokens, model.embed).to(getattr(torch, cfg.compute_dtype))
    h = block.attn_norm(x)
    q, k_new, v_new = attn.project_qkv(block.attn, h, cfg)
    pos = torch.full((tokens.shape[0], 1), position, dtype=torch.int32, device=device)
    out = attn.decode_attention_plus_one(q, cache["k"][0], cache["v"][0], k_new, v_new,
                                         position, window=cfg.swa_window)
    merged = attn.merge_heads(out)
    k_news = torch.stack([k_new] * cfg.n_layers)
    per_layer = {
        "attn_norm": lambda: block.attn_norm(x),
        "project_qkv": lambda: attn.project_qkv(block.attn, h, cfg),
        "rope_q": lambda: apply_rope(q, pos, cfg.rope_theta),
        "rope_k": lambda: apply_rope(k_new, pos, cfg.rope_theta),
        "decode_attention": lambda: attn.decode_attention_plus_one(
            q, cache["k"][0], cache["v"][0], k_new, v_new, position, window=cfg.swa_window),
        "wo": lambda: mm(merged, block.attn.wo),
        "mlp_norm": lambda: block.mlp_norm(x),
        "mlp": lambda: block.mlp(h),
        "residual_adds": lambda: (x + h) + h,
    }
    per_step = {
        "embed": lambda: F.embedding(tokens, model.embed).to(x.dtype),
        "cache_write": lambda: cache["k"][:, :, position:position + 1].copy_(k_news),
        "head": lambda: mm(model.final_norm(x), model.head()).to(torch.float32),
    }
    layer = {name: host_ms(fn, device, reps) for name, fn in per_layer.items()}
    step = {name: host_ms(fn, device, reps) for name, fn in per_step.items()}
    # the cache is written twice (k and v) a step
    total = cfg.n_layers * sum(layer.values()) + step["embed"] + 2 * step["cache_write"] \
        + step["head"]
    return {"per_layer_ms": layer, "per_step_ms": step, "pieces_total_ms": total}


def profile_step(step, device, trace_path):
    """Ops, launches, launch-call host time and device busy of one step."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    step()
    _sync(device)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("decode.step"):
            step()
            _sync(device)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    span = next(e for e in events if e.get("name") == "decode.step" and "dur" in e
                and e.get("cat") == "user_annotation")
    lo, hi = span["ts"], span["ts"] + span["dur"]
    inside = [e for e in events if "dur" in e and lo <= e["ts"] < hi]
    aten = [e for e in inside if e.get("cat") == "cpu_op"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in inside if e.get("cat") == "kernel"]
    launches = [e for e in inside if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    by_op: dict = {}
    for e in aten:
        hit = by_op.setdefault(e["name"], [0.0, 0])
        hit[0] += e["dur"]
        hit[1] += 1
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"step_span_ms": (hi - lo) / 1e3, "aten_ops": len(aten),
           "top_ops_inclusive": {name: {"ms": us / 1e3, "calls": n} for name, (us, n) in top}}
    if device.type == "cuda":
        busy = sum(e - s for s, e in union(kernels))
        out.update({"kernels": len(kernels), "launch_calls": len(launches),
                    "launch_calls_host_ms": sum(e["dur"] for e in launches) / 1e3,
                    "device_busy_ms": busy / 1e3,
                    "device_idle_share": 1.0 - busy / (hi - lo)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("decode_times: no CUDA card is available", file=sys.stderr)
        return 1

    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    kernel = "cuda" if device.type == "cuda" else "sorted"
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(cfg.sketch, kernel=kernel))
    b, prompt_len, steps = args.batch, args.prompt_len, args.steps
    model = M.init_params(cfg, torch.Generator(device).manual_seed(0), device)
    plan = ShardingPlan(cfg)
    prompt = TokenStream(cfg.vocab, b, prompt_len).next()["tokens"]
    last, cache = S.make_prefill_step(cfg, plan)(
        model, {"tokens": torch.from_numpy(prompt).to(device)})
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, steps + 1))
             for k, v in cache.items()}
    tokens = last.argmax(-1).to(torch.int32)[:, None]

    loops = {}
    for name, enabled in (("with_sketch", True), ("without_sketch", False)):
        serve = S.make_serve_step(cfg, plan, sketch_enabled=enabled, device=device)
        sketch = SK.init_token_sketch(cfg.sketch, 1, chunk=b, device=device)
        samples, tok = [], tokens
        for i in range(steps):
            t0 = time.perf_counter()
            tok, cache, sketch = serve(model, cache, tok, prompt_len + i, sketch)
            samples.append((time.perf_counter() - t0) * 1e3)
            tok = tok[:, None]
        _sync(device)
        loops[name] = {"host_ms_median": float(np.median(samples[1:])),
                       "host_ms_mean": float(np.mean(samples[1:]))}

    position = prompt_len + steps

    def one_step():
        with torch.no_grad():
            return M.decode_step(model, cache, tokens, position, cfg)

    def wall():
        _sync(device)
        t0 = time.perf_counter()
        one_step()
        _sync(device)
        return (time.perf_counter() - t0) * 1e3

    one_step()
    walls = [wall() for _ in range(5)]
    with torch.no_grad():
        split = pieces(model, cache, cfg, tokens, position, device, args.reps)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = Path(args.trace_dir) if args.trace_dir else Path(tmp)
        trace_dir.mkdir(parents=True, exist_ok=True)
        with torch.no_grad():
            prof = profile_step(one_step, device, trace_dir / "decode_step.json")
    record = {"arch": cfg.name, "dtype": cfg.param_dtype, "device": str(device),
              "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
              "batch": b, "prompt_len": prompt_len, "position": position,
              "steps": steps, "sketch_kernel": kernel, "serve_loop": loops,
              "step_wall_ms_median": float(np.median(walls)), "step_wall_ms": walls,
              "host_split": split, "profile": prof}
    print(json.dumps(record), flush=True)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
