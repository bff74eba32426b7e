"""What M-RoPE's section ids cost a qwen2-vl decode step.

    PYTHONPATH=src python tools/mrope_times.py [--layers 32] [--batch 4]
        [--prompt-len 320] [--steps 16] [--rounds 2] [--device cuda] [--smoke]

At ``chip_smoke.py`` phase 15c's geometry by default (qwen2-vl-72b at full
width cut to 32 of 80 layers, bf16, seeded weights made on the device, B 4,
a 320-token ``TokenStream`` prompt whose first 256 rows are the stream's
patch embeddings), after a prefill, ``--steps`` teacher-forced decode steps
(``models/model.decode_step``) are timed under two forms of
``rope.apply_mrope``'s per-slot section ids, in turns (``device``, ``host``,
``host``, ``device`` a round):

* ``device``: the form in ``models/rope.py``, two compares of an arange
  made on the device;
* ``host``: a tensor built from the sections tuple on the host and copied
  to the device on every call (the module's form before), which costs a
  host-to-device copy and a stream sync twice a layer.

Each step is timed by CUDA events around it and by the host clock; the
first step of each run is a warm-up and is left out. Both forms must give
the same logits bit for bit. Prints one JSON line, then the card's name
and power limit (on a card). On the CPU (``--device cpu``, with
``--smoke``) it runs as a rehearsal and prints no device number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch, get_smoke_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.serve import pad_cache
from repro_torch.models import model as M
from repro_torch.models import rope
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import steps as S


def host_sections_mrope(x, positions, theta, sections):
    """``rope.apply_mrope`` with its section ids made on the host and
    copied to the device on every call."""
    half = x.shape[-1] // 2
    ang_all = rope.rope_angles(positions, half, theta)
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(sections, device=x.device))
    ang = ang_all.movedim(0, -1).gather(
        -1, sec_id.expand(*ang_all.shape[1:3], half)[..., None])[..., 0]
    return rope._rotate(x, ang)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=320)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke arch (CPU rehearsal)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mrope_times: no CUDA card is available; pass --device cpu")
    on_card = device.type == "cuda"
    base = get_smoke_arch("qwen2-vl-72b") if args.smoke else get_arch("qwen2-vl-72b")
    cfg = dataclasses.replace(base, n_layers=min(args.layers, base.n_layers))
    b, p = args.batch, args.prompt_len
    model = M.init_params(cfg, torch.Generator(device).manual_seed(0), device)
    data = TokenStream(cfg.vocab, b, p + args.steps)
    host = data.next()
    host.update(data.extras(cfg))
    tokens = torch.from_numpy(host["tokens"]).to(device)
    prompt = {"tokens": tokens[:, :p],
              "vision_embeds": torch.from_numpy(host["vision_embeds"]).to(device),
              "positions": torch.from_numpy(host["positions"][:, :, :p].copy()).to(device)}
    _, cache0 = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, prompt)
    cache0 = pad_cache(cache0, p + args.steps)

    forms = {"device": rope.apply_mrope, "host": host_sections_mrope}
    runs = {name: [] for name in forms}
    logits = {}
    for _ in range(args.rounds):
        for name in ("device", "host", "host", "device"):
            M.apply_mrope = forms[name]
            try:
                cache = {k: v.clone() for k, v in cache0.items()}
                events, host_ms, out = [], [], []
                with torch.no_grad():
                    for i in range(args.steps):
                        start = torch.cuda.Event(enable_timing=True) if on_card else None
                        if on_card:
                            start.record()
                        t0 = time.perf_counter()
                        lg, cache, _ = M.decode_step(model, cache, tokens[:, p + i:p + i + 1],
                                                     p + i, cfg)
                        host_ms.append((time.perf_counter() - t0) * 1e3)
                        if on_card:
                            end = torch.cuda.Event(enable_timing=True)
                            end.record()
                            events.append((start, end))
                        out.append(lg)
                if on_card:
                    torch.cuda.synchronize(device)
            finally:
                M.apply_mrope = forms["device"]
            step_ms = [s.elapsed_time(e) for s, e in events] if on_card else None
            runs[name].append({"step_ms_mean": float(np.mean(step_ms[1:])) if on_card else None,
                               "host_ms_mean": float(np.mean(host_ms[1:]))})
            got = torch.stack(out).cpu()
            if name in logits and not torch.equal(logits[name], got):
                raise AssertionError(f"{name}: two runs of one form gave other logits")
            logits[name] = got
    if not torch.equal(logits["device"], logits["host"]):
        raise AssertionError("the two forms of the section ids gave other logits")

    def mean(name, key):
        vals = [r[key] for r in runs[name]]
        return float(np.mean(vals)) if None not in vals else None

    result = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "prompt_len": p,
              "steps": args.steps, "rounds": args.rounds, "device": str(device),
              "order": "device, host, host, device a round", "runs": runs,
              "step_ms_mean": {n: mean(n, "step_ms_mean") for n in forms},
              "host_ms_mean": {n: mean(n, "host_ms_mean") for n in forms},
              "logits_equal": True}
    if on_card:
        result["kind"] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
