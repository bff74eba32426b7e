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
restores in the other.

On a plan with a mesh (every family), the steps run on DTensors:
:func:`train_state_shardings`, :func:`batch_shardings` and
:func:`cache_shardings` give the placements of the state, the inputs and
the decode cache (JAX's NamedShardings, as DTensor placements): an SSM's
state with its headdim and its conv window with its channels on
``model``, every sequence cache (k/v, the hybrid's shared_k/shared_v,
whisper's ck/cv over its frames) with its sequence there.
:func:`init_train_state` and :func:`init_model` build the state on the
mesh, one unit at a time (no rank ever holds the whole model);
:func:`distribute_model` places a model built elsewhere (loaded weights)
and :func:`distribute_cache` a prefill's cache, its sequence caches
padded (whisper's ck/cv and an SSM's state and window keep their size;
a prefill leaves the state with its headdim on ``model`` already and the
window whole, which a local slice places). A step runs
under the plan's ``replicated()`` context; the train step redistributes
every gradient to its parameter's placements before the optimizer,
whose updates are in place; the token sketch is updated shard by shard
(``train/sketch.py:update_token_sketch``). The expert sketch stays a plain
tensor, the same on every rank (JAX keeps it replicated): every rank feeds
it the step's global expert counts, summed over the mesh by the MoE layer.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.core.spacesaving import Summary
from repro_torch.engine import SketchState
from repro_torch.models import model as M
from repro_torch.models.convert import stack_params, unstack_params
from repro_torch.models.layers import empty_param, whole_on
from repro_torch.optim import adamw
from repro_torch.sharding.rules import ShardingPlan, placements
from repro_torch.train import sketch as SK


class TrainState(NamedTuple):
    params: Any                 # the model (an LM); a tree in checkpoint_tree
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
    generator's), built by :func:`init_model`, or ``model`` (a built model
    on ``device``, on a mesh already placed by :func:`distribute_model`)
    as it is; its parameters are turned to take gradients. The optimizer's
    master weights are f32 copies of them and its moments zeros, made from
    each rank's shards on a mesh; the token sketch is placed by
    ``sketch.distribute_sketch`` there."""
    device = generator.device if device is None else torch.device(device)
    if model is None:
        model = init_model(cfg, plan, generator, device)
    model.requires_grad_(True)
    opt = adamw.init(dict(model.named_parameters()))
    token_sketch = SK.init_token_sketch(cfg.sketch, sketch_groups(plan), device=device)
    if plan.mesh is not None:
        opt = opt._replace(count=_distribute(opt.count, plan.mesh, placements((), plan.mesh)))
        token_sketch = SK.distribute_sketch(plan, token_sketch)
    return TrainState(
        params=model,
        opt=opt,
        token_sketch=token_sketch,
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


def train_state_shardings(cfg, plan: ShardingPlan) -> TrainState:
    """The placements of :func:`init_train_state`'s state on ``plan``'s
    mesh: every parameter (and its master weight and moments) by its
    logical axes (``models/model.py:state_dict_axes``), the count and the
    expert sketch replicated, the token sketch by ``sketch_shardings``."""
    mesh = plan.mesh
    shapes = M.param_shapes(cfg)
    pspecs = plan.param_specs(M.state_dict_axes(cfg), shapes)
    pl = {name: placements(spec, mesh) for name, spec in pspecs.items()}
    rep = placements((), mesh)
    groups = sketch_groups(plan)
    sk_tok = SK.sketch_shardings(plan, SK.token_sketch_shapes(cfg.sketch, groups,
                                                              device="cpu"))
    exp = SK.expert_sketch_shapes(cfg.sketch, device="cpu")
    sk_exp = SketchState(summary=Summary(*(rep for _ in exp.summary)), buffer=rep,
                            fill=rep, n=rep)
    return TrainState(params=pl, opt=adamw.AdamWState(master=pl, m=pl, v=pl, count=rep),
                      token_sketch=sk_tok, expert_sketch=sk_exp)


def batch_shardings(cfg, plan: ShardingPlan, batch_shapes: dict) -> dict:
    """Placements of the step inputs: tokens and labels on the batch axes
    (qwen2-vl's (3, B, S) positions on dim 1, frames and patch embeddings
    on dim 0), anything else replicated."""
    out = {}
    for name, s in batch_shapes.items():
        if name in ("tokens", "labels"):
            spec = plan.batch_spec(s.shape[0])
        elif name == "positions" and cfg.vlm is not None:
            spec = (None, *plan.batch_spec(s.shape[1]))
        elif name in ("frames", "vision_embeds"):
            spec = (plan.batch_spec(s.shape[0])[0], None, None)
        else:
            spec = ()
        out[name] = placements(spec, plan.mesh)
    return out


def cache_shardings(cfg, plan: ShardingPlan, cache_shapes: dict) -> dict:
    """Decode caches: sequence-parallel KV, model-sharded SSM headdim."""
    out = {}
    for name, s in cache_shapes.items():
        b = s.shape[1]
        bt = plan.batch_spec(b)[0]
        if name in ("k", "v", "ck", "cv", "shared_k", "shared_v"):
            seq = plan._cache_seq_axes((b,), seq_dim=s.shape[2])
            spec = (None, bt, seq, None, None)
        elif name in ("c_kv", "k_rope"):
            seq = plan._cache_seq_axes((b,), seq_dim=s.shape[2])
            spec = (None, bt, seq, None)
        elif name == "ssm_state":
            # (L,B,G,Hg,N,P): shard headdim P on model (always divisible)
            spec = (None, bt, None, None, None, "model")
        elif name == "conv":
            spec = (None, bt, None, "model")
        else:
            spec = ()
        out[name] = placements(spec, plan.mesh)
    return out


def _distribute(t: torch.Tensor, mesh, pl) -> DTensor:
    """``t`` (whole, the same on every rank) as a DTensor of placements
    ``pl``. Each rank keeps its own shard of its own copy (no collective),
    copied out when it is a view, so the whole tensor is freed as soon as
    the caller drops it."""
    dt = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage().nbytes() != local.numel() * local.element_size():
        dt = DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                                shape=dt.shape, stride=dt.stride())
    return dt


def _distribute_params(model: nn.Module, plan: ShardingPlan, pl: dict,
                       prefix: str = "") -> None:
    """Every parameter of ``model`` under ``prefix`` replaced in place by an
    ``nn.Parameter`` DTensor of placements ``pl[name]``, one at a time."""
    for name, p in list(model.named_parameters()):
        if prefix and name != prefix and not name.startswith(prefix + "."):
            continue
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(_distribute(p, plan.mesh, pl[name]), requires_grad=p.requires_grad))
        del p


def init_model(cfg, plan: ShardingPlan, generator: torch.Generator, device=None
               ) -> nn.Module:
    """``M.init_params(cfg, generator, device)``; on a mesh the same weights
    (the same draws in the same order) as DTensors placed by
    :func:`train_state_shardings`. The model is built on ``meta`` and each
    unit of ``LM.init_weights`` (a top-level parameter, or a layer) is
    allocated, filled and distributed before the next: no rank holds more
    of the whole model than one unit (qwen2.5-14b's layer, 0.55 GB in
    bf16; its embedding 1.56 GB) beside its own shards."""
    if plan.mesh is None:
        return M.init_params(cfg, generator, device)
    device = generator.device if device is None else torch.device(device)
    pl = train_state_shardings(cfg, plan).params
    model = M.build_params(cfg, "meta")

    def each(name, fill):
        try:
            model.get_submodule(name).to_empty(device=device)
        except AttributeError:                  # a parameter of the model itself
            meta = getattr(model, name)
            setattr(model, name, empty_param(meta.shape, meta.dtype, device))
        fill()
        _distribute_params(model, plan, pl, name)

    model.init_weights(generator, each)
    return model


def distribute_model(cfg, plan: ShardingPlan, model: nn.Module) -> nn.Module:
    """Every parameter of ``model`` (built whole and the same on every
    rank, as loaded weights are) replaced in place by an ``nn.Parameter``
    DTensor placed by :func:`train_state_shardings`, one tensor at a time,
    each whole copy dropped as soon as it is placed."""
    _distribute_params(model, plan, train_state_shardings(cfg, plan).params)
    return model


def distribute_cache(cfg, plan: ShardingPlan, cache: dict, max_len: int | None = None
                     ) -> dict:
    """A decode cache (DTensors, as the prefill step returns them, or whole
    tensors) in :func:`cache_shardings`, its sequence caches first padded
    with zeros to ``max_len`` positions (``launch/serve.py:pad_seq``, on
    each rank's rows with the sequence dim whole: DTensor has no sharding
    rule for a pad in every torch this runs on)."""
    from repro_torch.launch.serve import SEQ_CACHES, pad_seq
    mesh, out = plan.mesh, {}
    for name, t in cache.items():
        grow = max_len is not None and name in SEQ_CACHES
        shape = (*t.shape[:2], max_len, *t.shape[3:]) if grow else tuple(t.shape)
        final = cache_shardings(cfg, plan, {name: torch.empty(shape, device="meta")})[name]
        if grow:
            whole = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p for p in final]
            local = (t.redistribute(mesh, whole) if isinstance(t, DTensor)
                     else _distribute(t, mesh, whole)).to_local()
            t = DTensor.from_local(pad_seq(local, max_len), mesh, whole, run_check=False,
                                   shape=shape, stride=torch.empty(shape, device="meta").stride())
        out[name] = (t.redistribute(mesh, final) if isinstance(t, DTensor)
                     else _distribute(t, mesh, final))
    return out


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
    device, and the modality inputs the model takes (whisper's 'frames';
    qwen2-vl's 'vision_embeds' and M-RoPE 'positions' (3,B,S)), which go
    to ``loss_fn`` as they are. The step runs the loss and its backward under ``cfg.remat``,
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
        with plan.replicated(), torch.enable_grad():
            loss, aux = M.loss_fn(model, batch, cfg, plan.wsc, schedule=schedule)
            if isinstance(loss, DTensor):       # the global mean, on every rank
                loss = loss.redistribute(plan.mesh, placements((), plan.mesh))
            loss.backward()
        mark("backward")
        params = dict(model.named_parameters())
        grads = {n: p.grad for n, p in params.items()}
        if plan.mesh is not None:
            # the backward hands gradients back in placements of its own
            # (a Partial sum, say); the in-place update needs the param's
            grads = {n: g.redistribute(plan.mesh, params[n].placements)
                     for n, g in grads.items()}
        with plan.replicated():
            _, opt, metrics = adamw.update(grads, state.opt, M._dt(cfg), lr_fn=lr_fn,
                                           params=params)
        model.zero_grad(set_to_none=True)
        mark("optimizer")
        tok_sketch, exp_sketch = state.token_sketch, state.expert_sketch
        if update_sketch:
            tok_sketch = SK.update_token_sketch(tok_engine, tok_sketch, batch["tokens"])
            if cfg.moe is not None:
                # on a mesh: the counts summed over every rank's rows, as a
                # plain (E,) tensor, so every rank's expert sketch takes the
                # same update. Summing before the sketch is the paper's
                # ParallelReduction done on the counts: they are an exact
                # histogram (m₂ = 0), so their sum loses nothing and the
                # sketch of the sum is the one a single process keeps
                exp_sketch = SK.update_expert_sketch(exp_engine, exp_sketch,
                                                     _whole(aux["expert_counts"]))
        mark("sketch")
        metrics["loss"] = loss.detach()
        if cfg.moe is not None:
            metrics["moe_aux_loss"] = aux["aux_loss"].detach()
            metrics["expert_counts"] = aux["expert_counts"]
        metrics = {n: _whole(m) for n, m in metrics.items()}
        return TrainState(model, opt, tok_sketch, exp_sketch), metrics

    return train_step


def _whole(t):
    """A replicated DTensor (a metric) as the plain tensor every rank holds."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_prefill_step(cfg, plan: ShardingPlan, *, schedule: str = "masked"):
    def prefill_step(model, batch):
        """batch: the prompt's 'tokens' and modality inputs, as ``forward``
        takes them -> (last-position logits (B, V) f32, the KV cache of the
        prompt). On a mesh: DTensors in and out (the cache as the forward
        leaves it; ``distribute_cache`` puts it in ``cache_shardings``)."""
        with plan.replicated(), torch.no_grad():
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
    host side of each sketch update. On a mesh the model, the cache (in
    :func:`cache_shardings`), the tokens and the sketch are DTensors, and
    so are the next tokens.
    """
    tok_engine = SK.token_engine(cfg.sketch, sketch_groups(plan), device=device)
    update = sketch_enabled and cfg.sketch.enabled
    timed = sketch_timer.time if sketch_timer is not None else contextlib.nullcontext

    def serve_step(model, cache, tokens, position: int, token_sketch: SketchState):
        with plan.replicated(), torch.no_grad():
            logits, cache, _ = M.decode_step(model, cache, tokens, position, cfg,
                                             plan.wsc)
            # the vocab made whole first: DTensor's own redistribution for an
            # argmax over it fails for a batch of one row (long_500k's)
            next_tokens = whole_on(logits[:, -1], 1).argmax(-1).to(torch.int32)
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
