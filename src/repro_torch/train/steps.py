"""Step builders: prefill_step / serve_step / sketch merge.

The counterpart of ``repro.train.steps``'s serving half. Every step carries
the Space Saving sketch as first-class state:

  * prefill_step — forward with cache collection (the prompt pass);
  * serve_step — one decode token against the cache, the greedy next
    token, and the emitted tokens into the token sketch;
  * merge_step — the paper's ParallelReduction over the sketch group dim.

The training step (``TrainState``, ``init_train_state``,
``make_train_step``) needs ``optim/``, which is not ported yet.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.spacesaving import Summary
from repro_torch.engine import SketchState
from repro_torch.models import model as M
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK


def sketch_groups(plan: ShardingPlan) -> int:
    g = 1
    for a in plan.batch_axes:
        g *= plan.axis_sizes.get(a, 1)
    return max(g, 1)


def make_prefill_step(cfg, plan: ShardingPlan, *, schedule: str = "masked"):
    def prefill_step(model, batch):
        """-> (last-position logits (B, V) f32, the KV cache of the prompt)."""
        with torch.no_grad():
            logits, aux = M.forward(model, batch, cfg, plan.wsc, schedule=schedule,
                                    collect=True)
        return logits[:, -1], aux["cache"]

    return prefill_step


def make_serve_step(cfg, plan: ShardingPlan, *, sketch_enabled: bool = True,
                    device="cuda", sketch_timer=None):
    """``serve_step(model, cache, tokens (B, 1), position, token_sketch)``
    -> (next tokens (B,) int32, cache, token_sketch).

    The next token is the first maximum of the logits (``jnp.argmax``'s
    tie rule). The cache is written in place (``decode_step``) and so is
    the sketch's buffer (``update_token_sketch``). ``sketch_timer``, an
    object with a ``time()`` context manager (an obs Histogram), times the
    host side of each sketch update.
    """
    tok_engine = SK.token_engine(cfg.sketch, sketch_groups(plan), device=device)
    update = sketch_enabled and cfg.sketch.enabled
    timed = sketch_timer.time if sketch_timer is not None else contextlib.nullcontext

    def serve_step(model, cache, tokens, position: int, token_sketch: SketchState):
        with torch.no_grad():
            logits, cache, _ = M.decode_step(model, cache, tokens, position, cfg,
                                             plan.wsc)
        next_tokens = logits[:, -1].argmax(-1).to(torch.int32)
        if update:
            with timed():
                token_sketch = SK.update_token_sketch(tok_engine, token_sketch,
                                                      next_tokens[:, None])
        return next_tokens, cache, token_sketch

    return serve_step


def make_merge_step(cfg, *, device="cuda"):
    """Global sketch reduction — the paper's ParallelReduction.

    The engine's merge path takes the tenant count from the state, so one
    merge step serves token sketches of any group count.
    """
    engine = SK.token_engine(cfg.sketch, 1, device=device)

    def merge_step(token_sketch: SketchState) -> Summary:
        return SK.merge_sketches(engine, token_sketch)
    return merge_step
