"""AdamW + LR schedules + global-norm clipping, written out (no torch.optim).

The counterpart of ``repro.optim.adamw``, in the same f32 arithmetic:
grads to f32, clipped by their global norm, ``count + 1``, ``lr_fn(count)``,
the bias corrections ``1 − b^count`` in f32, then
``(m/c1)/(sqrt(v/c2)+eps) + wd·p`` and the master weights cast back to the
param dtype. ``torch.optim.AdamW`` is not used: it places eps and applies
the decoupled decay in another order, so it rounds differently.

Mixed precision: forward and backward run in the model's param dtype
(bf16); the optimizer keeps f32 master weights and moments.

The state is updated in place, one tensor at a time: master, m and v, then
the live params (``param.copy_(master)``). This is the port's counterpart
of JAX's buffer donation (``launch/train.py``'s ``donate_argnums``): no
second f32 copy of the whole tree is ever held, only the temporaries of the
tensor at hand. Call :func:`update` after ``backward()``; it runs under
``torch.no_grad()``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    master: dict          # name -> f32 master param
    m: dict               # name -> f32 first moment
    v: dict               # name -> f32 second moment
    count: torch.Tensor   # 0-d int32 step


def init(params: dict) -> AdamWState:
    """f32 copies of ``params`` (name -> tensor) and zero moments, each
    of its param's placements where the params are DTensors.

    The master weights are always copies, even of f32 params: they must
    never alias the live params, which the update writes from them.
    """
    with torch.no_grad():
        master = {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()}
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for n, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return AdamWState(master=master, m=zeros(), v=zeros(),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    leaves = [a.to(torch.float32).square().sum() for a in _leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine down
    to ``min_frac·base_lr`` at ``total``; ``lr(step)`` is an f32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def update(grads: dict, state: AdamWState, param_dtype, *, lr_fn, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: float = 1.0, params: dict | None = None):
    """One AdamW step; returns ``(new_params, state, metrics)``.

    ``state`` is updated in place and returned. ``params`` (name -> the
    live tensors) are written in place from the new master weights and
    returned; without them, ``new_params`` are fresh ``param_dtype`` copies
    of the master weights. ``metrics``: ``grad_norm`` (before clipping) and
    ``lr``, 0-d f32 tensors.
    """
    with torch.no_grad():
        norm = global_norm(grads)
        scale = _clip_scale(norm, clip_norm)
        state.count.add_(1)
        lr = lr_fn(state.count)
        count = state.count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, count)
        c2 = 1.0 - torch.pow(b2, count)
        new_params = {}
        for name, grad in grads.items():
            master, m, v = state.master[name], state.m[name], state.v[name]
            g = grad.to(torch.float32, copy=True).mul_(scale)
            gg = g * (1 - b2)
            gg.mul_(g)
            v.mul_(b2).add_(gg)
            del gg
            g.mul_(1 - b1)
            m.mul_(b1).add_(g)
            del g
            upd = m / c1
            denom = (v / c2).sqrt_().add_(eps)
            upd.div_(denom)
            del denom
            upd.add_(master * weight_decay)
            master.sub_(upd.mul_(lr))
            del upd
            if params is not None:
                params[name].copy_(master)
                new_params[name] = params[name]
            else:
                new_params[name] = master.to(param_dtype)
    return new_params, state, {"grad_norm": norm, "lr": lr}
