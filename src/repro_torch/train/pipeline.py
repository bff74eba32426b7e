"""Pipeline parallelism (the GPipe schedule) over a process group.

The counterpart of ``repro.train.pipeline``. Layers are grouped into S
stages, one a rank of ``group``; micro-batches flow stage to stage by
paired point-to-point sends (``dist.batch_isend_irecv``, as
``core/parallel.py`` pairs the butterfly), in the classic (S + M − 1)-tick
GPipe loop:

    tick t: stage s computes micro-batch (t − s) if 0 ≤ t − s < M,
            then hands its activation to stage s + 1.

The bubble fraction is (S − 1)/(M + S − 1); choose M ≫ S.

Gradients: ``jax.grad`` differentiates ``lax.ppermute`` by the reverse
permute for free; here :class:`_ShiftToNext` is an autograd Function whose
backward sends an activation's gradient to stage s − 1. Every rank runs
the same ticks and the same operations (inactive ticks compute on zeros
and are masked, as the JAX loop does), so every rank's backward reaches
the sends in the same order and each pairs with its neighbour's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """``x`` sent to the rank ``step`` places up the ring of ``group``; the
    tensor received from the rank ``step`` places down."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    rank = dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + step) % n) if group is not None \
        else (rank + step) % n
    src = dist.get_global_rank(group, (rank - step) % n) if group is not None \
        else (rank - step) % n
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _ShiftToNext(torch.autograd.Function):
    """``lax.ppermute`` by +1 around the stages; its transpose shifts the
    gradient by −1."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _shift(y, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, -1, ctx.group), None


class _SumToAll(torch.autograd.Function):
    """``lax.psum`` of the last stage's outputs to every rank. The loss on
    top of it is computed on every rank alike (replicated), so each rank's
    share of the sum takes the loss's gradient as it is: the backward is
    the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _select(tree, s: int):
    if isinstance(tree, dict):
        return {k: _select(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_select(v, s) for v in tree)
    return tree[s]


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, group=None,
                   n_micro: int) -> torch.Tensor:
    """Run ``x`` through the S pipelined stages of ``group`` (S its size).

    stage_params: a tree (dicts, lists) of tensors with leading dim S; rank
    s applies slice s. x: (M, mb, ...) micro-batched input, the same on
    every rank (only stage 0 reads it). stage_fn(params_slice, activation)
    -> activation of the same shape and dtype. Returns the (M, mb, ...)
    outputs of the last stage on every rank. Every rank of ``group`` calls
    it with the same shapes.
    """
    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    params = _select(stage_params, s)
    m = x.shape[0]
    if n_micro != m:
        raise ValueError(f"pipeline_apply: n_micro {n_micro} != x.shape[0] {m}")
    first = torch.tensor(s == 0, device=x.device)
    recv = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    rows = torch.arange(m, device=x.device).reshape(m, *[1] * (x.dim() - 1))
    for t in range(m + n_stages - 1):
        mb = t - s
        active = 0 <= mb < m
        x_in = torch.where(first, x[min(max(mb, 0), m - 1)], recv)
        y = stage_fn(params, x_in)
        y = torch.where(torch.tensor(active, device=x.device), y, torch.zeros_like(y))
        # the last stage writes its finished micro-batch (a no-op elsewhere)
        write = active and s == n_stages - 1
        outs = torch.where((rows == mb) & write, y.unsqueeze(0), outs)
        recv = _ShiftToNext.apply(y, group)
    return _SumToAll.apply(outs, group)


def pipelined_loss(stage_fn, loss_fn, stage_params, x, targets, *, group=None,
                   n_micro: int):
    """``loss_fn(outputs, targets)`` over the pipeline's outputs; its
    backward runs the pipeline in reverse (every rank calls it)."""
    outs = pipeline_apply(stage_fn, stage_params, x, group=group, n_micro=n_micro)
    return loss_fn(outs, targets)
