"""Rotary position embeddings — interleaved formulation, plus M-RoPE.

The counterpart of ``repro.models.rope``. The *interleaved* layout rotates
adjacent pairs (x[2i], x[2i+1]), not the half-split ``rotate_half`` of most
PyTorch code: pairs never straddle a head_dim shard boundary, and the JAX
package's weights and caches assume it. Angles are f32,
``positions * theta ** (-arange(half) / half)``; the rotation runs in f32
and the result is cast back to ``x.dtype``.

M-RoPE (Qwen2-VL): head_dim/2 frequency slots are split into
(temporal, height, width) sections; each section takes its rotation angle
from the corresponding row of a (3, B, S) position tensor.
"""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, half: int, theta: float) -> torch.Tensor:
    """(..., S) int positions -> (..., S, half) f32 angles."""
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions.to(torch.float32)[..., None] * freqs


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of x (B, S, H, hd) by ang (B, S, half)."""
    cos = torch.cos(ang)[:, :, None, :]                # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.to(torch.float32).reshape(*x.shape[:-1], -1, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> rotated x (interleaved pairs)."""
    return _rotate(x, rope_angles(positions, x.shape[-1] // 2, theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """x (B, S, H, hd), positions (3, B, S) — Qwen2-VL multimodal RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    ang_all = rope_angles(positions, half, theta)       # (3, B, S, half)
    # pick the t/h/w angle stream per frequency slot: 0 for the first
    # sections[0] slots, 1 for the next sections[1], 2 for the rest (made
    # on the device: a host tensor would cost a copy and a sync a call)
    slot = torch.arange(half, device=x.device)
    sec_id = (slot >= sections[0]).long() + (slot >= sections[0] + sections[1]).long()
    ang = ang_all.movedim(0, -1).gather(                 # (B, S, half, 3)
        -1, sec_id.expand(*ang_all.shape[1:3], half)[..., None])[..., 0]
    return _rotate(x, ang)
