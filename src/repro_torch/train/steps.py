"""Step builders: train_step / prefill_step / serve_step / sketch merge.

The counterpart of ``repro.train.steps``. Every step carries the Space
Saving sketch as first-class state:

  * train_step — loss and backward under the remat policy, AdamW (f32
    master weights, updated in place), the token sketch updated on the
    input batch and, for the MoE family, the expert sketch on the router's
    per-step expert counts;
  * prefill_step — forward with cache collection (the prompt pass);
  * serve_step — one decode token against the cache, the greedy next
    token, and the emitted tokens into the token sketch;
  * merge_step — the paper's ParallelReduction over the sketch group dim.

``TrainState.params`` is the model (an ``nn.Module``); the optimizer's
master weights and moments are dicts under its ``state_dict`` keys.
:func:`checkpoint_tree` lays the state out as the JAX package's
``TrainState`` (params, master, m and v stacked per layer by
``models/convert.py``), so that a train checkpoint of either package
restores in the other. ``train_state_shardings``, ``batch_shardings`` and
``cache_shardings`` wait for the mesh resolver (ROADMAP.md §1 item 7).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from repro_torch.core.spacesaving import Summary
from repro_torch.engine import SketchState
from repro_torch.models import model as M
from repro_torch.models.convert import stack_params, unstack_params
from repro_torch.optim import adamw
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK


class TrainState(NamedTuple):
    params: Any                 # the model (DenseLM); a tree in checkpoint_tree
    opt: adamw.AdamWState
    token_sketch: SketchState
    expert_sketch: SketchState


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------

def sketch_groups(plan: ShardingPlan) -> int:
    g = 1
    for a in plan.batch_axes:
        g *= plan.axis_sizes.get(a, 1)
    return max(g, 1)


def init_train_state(cfg, generator: torch.Generator, plan: ShardingPlan, *,
                     device=None, model=None) -> TrainState:
    """Fresh weights from ``generator`` on ``device`` (default: the
    generator's), or ``model`` (a built model on ``device``) as it is; its
    parameters are turned to take gradients. The optimizer's master
    weights are f32 copies of them."""
    device = generator.device if device is None else torch.device(device)
    if model is None:
        model = M.init_params(cfg, generator, device)
    model.requires_grad_(True)
    return TrainState(
        params=model,
        opt=adamw.init(dict(model.named_parameters())),
        token_sketch=SK.init_token_sketch(cfg.sketch, sketch_groups(plan), device=device),
        expert_sketch=SK.init_expert_sketch(cfg.sketch, device=device),
    )


def train_state_shapes(cfg, plan: ShardingPlan) -> TrainState:
    """The state of :func:`init_train_state` as ``meta`` tensors, the
    params as the model's ``state_dict``."""
    shapes = M.param_shapes(cfg)
    f32 = lambda: {n: torch.empty(t.shape, dtype=torch.float32, device="meta")  # noqa: E731
                   for n, t in shapes.items()}
    return TrainState(
        params=shapes,
        opt=adamw.AdamWState(master=f32(), m=f32(), v=f32(),
                             count=torch.empty((), dtype=torch.int32, device="meta")),
        token_sketch=SK.token_sketch_shapes(cfg.sketch, sketch_groups(plan), device="cpu"),
        expert_sketch=SK.expert_sketch_shapes(cfg.sketch, device="cpu"),
    )


def checkpoint_tree(cfg, state: TrainState) -> TrainState:
    """``state`` in the JAX package's layout, what a train checkpoint holds:
    params, master, m and v as trees of CPU tensors with the layers stacked
    (``models/convert.py:stack_params``); the count and the sketches as
    they are. ``state`` may also be :func:`train_state_shapes`'s."""
    def tree(tensors: dict) -> dict:
        return stack_params(cfg, {n: t.detach().to("cpu") if t.device.type != "meta" else t
                                  for n, t in tensors.items()})

    params = state.params
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    opt = state.opt
    return TrainState(params=tree(params),
                      opt=adamw.AdamWState(tree(opt.master), tree(opt.m), tree(opt.v),
                                           opt.count),
                      token_sketch=state.token_sketch, expert_sketch=state.expert_sketch)


def load_checkpoint_tree(cfg, state: TrainState, tree: TrainState) -> TrainState:
    """Copy a :func:`checkpoint_tree` (as restored) into ``state``'s model
    and optimizer tensors in place; returns ``state`` with the tree's
    sketches."""
    model, opt = state.params, state.opt
    live = dict(model.named_parameters())
    with torch.no_grad():
        for dst, src in ((live, tree.params), (opt.master, tree.opt.master),
                         (opt.m, tree.opt.m), (opt.v, tree.opt.v)):
            loaded = unstack_params(cfg, src)
            if loaded.keys() != dst.keys():
                raise ValueError(f"checkpoint leaves {sorted(loaded)} != the state's "
                                 f"{sorted(dst)}")
            for name, t in loaded.items():
                dst[name].copy_(t)
        opt.count.copy_(tree.opt.count)
    return state._replace(token_sketch=tree.token_sketch,
                          expert_sketch=tree.expert_sketch)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_train_step(cfg, plan: ShardingPlan, *, lr_fn=None, schedule: str = "masked",
                    sketch_enabled: bool = True, device="cuda", timer=None):
    """``train_step(state, batch)`` -> (state, metrics).

    batch: {'tokens' (B,S) int32, 'labels' (B,S) int32} on the state's
    device. The step runs the loss and its backward under ``cfg.remat``,
    then :func:`adamw.update` (master weights, moments and the live params
    in place), sets the grads to None, and feeds ``batch['tokens']`` to the
    token sketch (whose buffer is written in place); for the MoE family the
    forward's ``expert_counts`` (E,), summed over the layers, go to the
    expert sketch. ``metrics``: ``loss``, ``grad_norm`` and ``lr``, and for
    the MoE family ``moe_aux_loss``, 0-d f32 tensors, and the step's
    ``expert_counts`` (E,) int32. ``timer``, an object
    with a ``mark(name)`` method, is called at the boundaries ``start``,
    ``backward``, ``optimizer`` and ``sketch`` of every step (both sketches
    lie between the last two).
    """
    M.check_family(cfg)
    lr_fn = lr_fn or adamw.cosine_schedule(3e-4, 100, 10_000)
    tok_engine = SK.token_engine(cfg.sketch, sketch_groups(plan), device=device)
    exp_engine = SK.expert_engine(cfg.sketch, device=device)
    update_sketch = sketch_enabled and cfg.sketch.enabled
    mark = timer.mark if timer is not None else (lambda name: None)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        mark("start")
        with torch.enable_grad():
            loss, aux = M.loss_fn(model, batch, cfg, plan.wsc, schedule=schedule)
            loss.backward()
        mark("backward")
        params = dict(model.named_parameters())
        grads = {n: p.grad for n, p in params.items()}
        _, opt, metrics = adamw.update(grads, state.opt, M._dt(cfg), lr_fn=lr_fn,
                                       params=params)
        model.zero_grad(set_to_none=True)
        mark("optimizer")
        tok_sketch, exp_sketch = state.token_sketch, state.expert_sketch
        if update_sketch:
            tok_sketch = SK.update_token_sketch(tok_engine, tok_sketch, batch["tokens"])
            if cfg.moe is not None:
                exp_sketch = SK.update_expert_sketch(exp_engine, exp_sketch,
                                                     aux["expert_counts"])
        mark("sketch")
        metrics["loss"] = loss.detach()
        if cfg.moe is not None:
            metrics["moe_aux_loss"] = aux["aux_loss"].detach()
            metrics["expert_counts"] = aux["expert_counts"]
        return TrainState(model, opt, tok_sketch, exp_sketch), metrics

    return train_step


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
