"""Norms, MLPs and positions: the common layers of the LM substrate.

The counterpart of ``repro.models.layers``. The JAX package builds its
parameters through ``Ctx`` and ``stacked``, which run one builder in XLA's
init, shape and axes modes. Their counterparts here are ``nn.Module``
construction (every parameter is allocated by its module, in the JAX
layout: a matrix is (in, out) and applies as ``x @ w``), the ``meta``
device for shapes without allocation, and ``models/convert.py``, which
carries the JAX package's stacked per-layer leaves into these modules.

Norms are computed in f32 and cast back to the input's dtype; the MLP runs
in the compute dtype (SwiGLU, or GELU with biases).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard


def empty_param(shape, dtype, device) -> nn.Parameter:
    """An unfilled parameter that takes no gradient until a trainer asks for
    one (``train/steps.py:init_train_state`` turns gradients on), so a
    serving forward records no graph."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def normal_(p: torch.Tensor, generator: torch.Generator,
            scale: float | None = None) -> None:
    """Fill ``p`` with N(0, 1)·scale drawn in f32, the JAX package's init:
    ``scale`` defaults to fan_in^-½ (fan_in = shape[0] of a vector, else
    shape[-2])."""
    if scale is None:
        fan_in = p.shape[0] if p.dim() == 1 else p.shape[-2]
        scale = fan_in ** -0.5
    with torch.no_grad():
        draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                           device=p.device)
        p.copy_(draw.mul_(scale))


def uniform_(p: torch.Tensor, generator: torch.Generator) -> None:
    """Fill ``p`` with U[0, 1) drawn in f32, the JAX package's ``uniform``
    init (an SSM's ``dt_bias``)."""
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=generator, dtype=torch.float32,
                           device=p.device))


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation's dtype."""
    return x @ w.to(x.dtype)


def whole_on(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor made whole on dim ``dim`` (every other placement kept); a
    plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == dim
                                          else p for p in t.placements])


def grad_as_placed(t: DTensor) -> DTensor:
    """``t`` itself, its gradient brought back in ``t``'s placements (a
    redistribute to its own placements): for a view whose backward could
    not take the gradient in the placements the next op's backward gives
    it (a flat dim cut into pieces that are not whole rows of the view)."""
    return t.redistribute(t.device_mesh, t.placements)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)

    def init_weights(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps) * self.scale.to(torch.float32)
        return out.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)
        self.bias = empty_param((d,), dtype, device)

    def init_weights(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + self.eps)
        out = out * self.scale.to(torch.float32) + self.bias.to(torch.float32)
        return out.to(x.dtype)


def make_norm(d: int, norm_type: str, eps: float, *, dtype, device=None) -> nn.Module:
    if norm_type == "rmsnorm":
        return RMSNorm(d, eps, dtype=dtype, device=device)
    if norm_type == "layernorm":
        return LayerNorm(d, eps, dtype=dtype, device=device)
    raise ValueError(f"norm_type {norm_type!r} not in ('rmsnorm', 'layernorm')")


class MLP(nn.Module):
    """SwiGLU (``act='silu'``: w_gate, w_up, w_down) or a GELU MLP with
    biases (w_up, b_up, w_down, b_down)."""

    def __init__(self, d: int, f: int, act: str, *, dtype, device=None):
        super().__init__()
        self.act = act
        if act == "silu":
            self.w_gate = empty_param((d, f), dtype, device)
            self.w_up = empty_param((d, f), dtype, device)
        else:
            self.w_up = empty_param((d, f), dtype, device)
            self.b_up = empty_param((f,), dtype, device)
            self.b_down = empty_param((d,), dtype, device)
        self.w_down = empty_param((f, d), dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.startswith("b_"):
                with torch.no_grad():
                    p.zero_()
            else:
                normal_(p, generator)

    def forward(self, x: torch.Tensor, wsc=None) -> torch.Tensor:
        wsc = wsc or (lambda a, _: a)
        if self.act == "silu":
            h = F.silu(mm(x, self.w_gate)) * mm(x, self.w_up)
            return mm(wsc(h, "btf"), self.w_down)
        h = F.gelu(mm(x, self.w_up) + self.b_up.to(x.dtype), approximate="tanh")
        return mm(wsc(h, "btf"), self.w_down) + self.b_down.to(x.dtype)


def sinusoidal_positions(n: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings (n, d)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=device) / (half - 1))
    args = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(dtype)
