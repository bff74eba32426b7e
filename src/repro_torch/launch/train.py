"""End-to-end training driver.

The counterpart of ``repro.launch.train``, on every family (``--arch``
defaults to mamba2-130m, as the JAX launcher's does); each batch carries
the stream's stub modality inputs (``TokenStream.extras``: whisper's
frames, qwen2-vl's patch embeddings and M-RoPE positions).
Real steps with the whole substrate engaged: AdamW with f32 master
weights, the Space Saving token sketch on every batch (and for the MoE
family the expert sketch on the router's counts), a global sketch merge every
``--merge-every`` steps (the paper's ParallelReduction), atomic checkpoints
in the JAX package's layout, and crash/restart resume: ``--crash-at``
simulates a failure after that step (exit code 42); rerunning the same
command resumes from the last complete checkpoint and reproduces the exact
batch sequence (the data cursor is restored, nothing is replayed). A
checkpoint written by either package's trainer resumes in the other's.

The work is :func:`run_train`, which returns the per-step losses, grad
norms and learning rates, the tokens it trained on, the final state and
the timings. Entry points run on the card unless ``--device cpu`` asks
for the CPU; without a card, ``--device cuda`` raises.

  python -m repro_torch.launch.train --device cpu --arch mamba2-130m --smoke \\
      --steps 8 --batch 2 --seq 64 --ckpt-every 4 --merge-every 4 --ckpt-dir /tmp/ck
  # add --crash-at 4, then rerun without it: "[resume] restored step 4"
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import manager as CKPT
from repro_torch.configs.registry import get_arch, get_smoke_arch
from repro_torch.core.exact import evaluate
from repro_torch.core.spacesaving import sort_summary
from repro_torch.data.synthetic import DataState, TokenStream
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import steps as S

K_MAJORITY = 100      # the final report's k-majority threshold (n/k)


class _StepMarks:
    """The boundaries of every train step (``make_train_step``'s ``timer``):
    the host clock at each mark, and a CUDA event on a card."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.steps: list[dict] = []

    def mark(self, name: str) -> None:
        if name == "start":
            self.steps.append({})
        ev = None
        if self.on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.steps[-1][name] = (ev, time.perf_counter())

    def split(self) -> dict:
        """Per step: event ms of the whole step, of the forward + backward,
        of the clip + AdamW and of the sketch update (None on the CPU), and
        the host ms of the sketch update and of the whole step."""
        def ms(step, a, b):
            return step[a][0].elapsed_time(step[b][0]) if self.on_card else None
        return {
            "step_ms": [ms(s, "start", "sketch") for s in self.steps],
            "fwd_bwd_ms": [ms(s, "start", "backward") for s in self.steps],
            "optimizer_ms": [ms(s, "backward", "optimizer") for s in self.steps],
            "sketch_ms": [ms(s, "optimizer", "sketch") for s in self.steps],
            "sketch_host_ms": [(s["sketch"][1] - s["optimizer"][1]) * 1e3
                               for s in self.steps],
            "step_host_ms": [(s["sketch"][1] - s["start"][1]) * 1e3 for s in self.steps],
        }


def run_train(cfg, *, steps: int = 100, batch: int = 8, seq: int = 256,
              lr: float = 3e-4, skew: float = 1.1, ckpt_dir=None, ckpt_every: int = 25,
              merge_every: int = 32, log_every: int = 10, crash_at: int | None = None,
              seed: int = 0, device="cuda", model=None) -> dict:
    """Train ``steps`` steps on TokenStream batches; returns the run's record.

    ``model`` (a built model on ``device``) defaults to fresh weights from
    ``torch.Generator(device)`` seeded with ``seed``. ``ckpt_dir``: the
    checkpoints go under ``ckpt_dir/<arch>`` (resumed from its latest
    complete step); ``None`` (a harness's choice) writes none and resumes
    nothing. ``crash_at`` raises ``SystemExit(42)`` after that step. The
    record: ``start`` (the resumed step), per-step ``losses``,
    ``grad_norms`` and ``lrs`` (floats, steps ``start+1..steps``), for the
    MoE family per-step ``moe_aux_losses`` and ``expert_counts`` (steps ×
    E int32, what the expert sketch was fed), the
    ``tokens`` trained on (steps × B·S int32), the ``state``, the merged
    sketch's top-5 at every merge, the final k-majority report against the
    replayed stream, and ``timings`` (CUDA-event splits on a card).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_train: no CUDA card is available; pass device='cpu'")
    on_card = device.type == "cuda"
    plan = ShardingPlan(cfg, None)        # one process: no mesh constraints
    marks = _StepMarks(on_card)
    train_step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(lr, 20, steps),
                                   device=device, timer=marks)
    merge_step = S.make_merge_step(cfg, device=device)

    data = TokenStream(cfg.vocab, batch, seq, skew=skew)
    state = S.init_train_state(cfg, torch.Generator(device).manual_seed(seed), plan,
                               device=device, model=model)
    start = 0
    ckpt_dir = Path(ckpt_dir) / cfg.name if ckpt_dir is not None else None
    latest = CKPT.latest_step(ckpt_dir) if ckpt_dir is not None else None
    if latest is not None:
        tree, dstate = CKPT.restore(ckpt_dir, latest, S.checkpoint_tree(cfg, state))
        state = S.load_checkpoint_tree(cfg, state, tree)
        data.state = DataState.from_dict(dstate)
        start = latest
        print(f"[resume] restored step {latest} from {ckpt_dir}", flush=True)

    print(f"[train] arch={cfg.name} params={M.param_count(cfg):,} "
          f"steps {start}..{steps}", flush=True)
    seen, metrics_seen, tops = [], [], []
    t0 = time.time()
    t_loop = time.perf_counter()
    for step in range(start, steps):
        host = data.next()
        host.update(data.extras(cfg))
        seen.append(host["tokens"].reshape(-1))
        inputs = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        state, metrics = train_step(state, inputs)
        metrics_seen.append(metrics)

        if (step + 1) % log_every == 0:
            tps = batch * seq * log_every / (time.time() - t0)
            t0 = time.time()
            print(f"  step {step+1:5d} loss {float(metrics['loss']):7.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} tok/s {tps:9.0f}", flush=True)

        if (step + 1) % merge_every == 0:
            top = sort_summary(merge_step(state.token_sketch), ascending=False)
            items, counts = top.items[:5].tolist(), top.counts[:5].tolist()
            tops.append({"step": step + 1, "items": items, "counts": counts})
            print(f"  [sketch] step {step+1} top tokens: "
                  + ", ".join(f"{i}:{c}" for i, c in zip(items, counts)), flush=True)

        if ckpt_dir is not None and ((step + 1) % ckpt_every == 0 or step + 1 == steps):
            CKPT.save(ckpt_dir, step + 1, S.checkpoint_tree(cfg, state),
                      data.state.to_dict())

        if crash_at is not None and step + 1 >= crash_at:
            print(f"[crash] simulated failure at step {step+1} "
                  f"(restart resumes from the last checkpoint)", flush=True)
            raise SystemExit(42)
    if on_card:
        torch.cuda.synchronize(device)
    loop_s = time.perf_counter() - t_loop

    # final report: the merged sketch against exact counts of the whole
    # logical stream, replayed from the start (steps before a restart too)
    merged = merge_step(state.token_sketch)
    replay = TokenStream(cfg.vocab, batch, seq, skew=skew)
    stream = (np.concatenate([replay.next()["tokens"].reshape(-1) for _ in range(steps)])
              if steps else np.zeros(0, np.int32))
    final = None
    if stream.size:
        final = evaluate(merged, stream, K_MAJORITY)
        print(f"[sketch-final] k-majority(k={K_MAJORITY}) ARE={final.are:.2e} "
              f"precision={final.precision:.3f} recall={final.recall:.3f} "
              f"({final.n_reported} reported / {final.n_true} true)", flush=True)
    print("[train] done", flush=True)

    def floats(key):
        return torch.stack([m[key] for m in metrics_seen]).tolist() if metrics_seen else []

    n_run = steps - start
    timings = {"loop_s": loop_s, **marks.split(),
               "tok_per_s": batch * seq * n_run / loop_s if n_run else None}
    moe = {}
    if cfg.moe is not None:
        moe = {"moe_aux_losses": floats("moe_aux_loss"),
               "expert_counts": (torch.stack([m["expert_counts"] for m in metrics_seen])
                                 .cpu().numpy() if metrics_seen
                                 else np.zeros((0, cfg.moe.n_experts), np.int32))}
    return {"arch": cfg.name, "device": str(device), "start": start, "steps": steps,
            "batch": batch, "seq": seq, "losses": floats("loss"),
            "grad_norms": floats("grad_norm"), "lrs": floats("lr"), **moe,
            "tokens": np.stack(seen) if seen else np.zeros((0, batch * seq), np.int32),
            "state": state, "merged": merged, "tops": tops, "final": final,
            "timings": timings}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m",
                    help="a dense GQA arch (qwen2.5-14b, yi-34b, qwen1.5-110b), "
                         "MLA (minicpm3-4b), MoE (qwen3-moe-30b-a3b, mixtral-8x7b), "
                         "SSM (mamba2-130m), hybrid (zamba2-7b), audio (whisper-tiny) "
                         "or vlm (qwen2-vl-72b)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--skew", type=float, default=1.1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--merge-every", type=int, default=32)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a failure after this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model, the optimizer state and the sketch live")
    args = ap.parse_args(argv)

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    return run_train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                     skew=args.skew, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     merge_every=args.merge_every, log_every=args.log_every,
                     crash_at=args.crash_at, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
