"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The counterpart of ``repro.models.mla``. Prefill expands the latent to
full K/V and reuses the blockwise attention. Decode uses the *absorbed*
formulation: queries are projected into the kv-latent space (absorbing
W_uk) so scores are taken directly against the cached latent. The cache is
(c_kv, k_rope), kv_rank + rope_dim values a position instead of 2·H·hd.

As in the JAX package, the prefill's products run in the compute dtype and
the decode's absorbed products in f32.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.attention import blockwise_attention, merge_heads
from repro_torch.models.layers import empty_param, mm, normal_
from repro_torch.models.rope import apply_rope


class MLA(nn.Module):
    """The MLA projections of one layer, in the JAX layout ((in, out)
    matrices): ``wdq`` (D, q_lora), ``q_norm_scale``, ``wuq`` (q_lora,
    H·(nope+rope)), ``wdkv`` (D, kv_lora + rope), ``kv_norm_scale``, ``wuk``
    (kv_lora, H·nope), ``wuv`` (kv_lora, H·v) and ``wo`` (H·v, D)."""

    def __init__(self, cfg, *, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wdq = empty_param((d, m.q_lora_rank), dtype, device)
        self.q_norm_scale = empty_param((m.q_lora_rank,), dtype, device)
        self.wuq = empty_param((m.q_lora_rank, h * qk), dtype, device)
        self.wdkv = empty_param((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype, device)
        self.kv_norm_scale = empty_param((m.kv_lora_rank,), dtype, device)
        self.wuk = empty_param((m.kv_lora_rank, h * m.qk_nope_head_dim), dtype, device)
        self.wuv = empty_param((m.kv_lora_rank, h * m.v_head_dim), dtype, device)
        self.wo = empty_param((h * m.v_head_dim, d), dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        hv = cfg.n_heads * cfg.mla.v_head_dim
        for name, p in self.named_parameters():
            if name.endswith("_norm_scale"):
                with torch.no_grad():
                    p.fill_(1.0)
            elif name == "wo":
                normal_(p, generator, scale=hv ** -0.5 / math.sqrt(2 * cfg.n_layers))
            else:
                normal_(p, generator)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def _project_q(p: MLA, x: torch.Tensor, cfg):
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = _rms(mm(x, p.wdq), p.q_norm_scale, cfg.norm_eps)
    q = mm(cq, p.wuq).reshape(b, s, cfg.n_heads, qk)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def _project_latent(p: MLA, x: torch.Tensor, cfg):
    m = cfg.mla
    lat = mm(x, p.wdkv)
    c_kv = _rms(lat[..., :m.kv_lora_rank], p.kv_norm_scale, cfg.norm_eps)
    return c_kv, lat[..., m.kv_lora_rank:]


def mla_prefill(p: MLA, x: torch.Tensor, cfg, positions: torch.Tensor, *,
                block_q=512, block_kv=512, schedule="masked"):
    """Full-expansion MLA attention over a sequence. x (B,S,D) ->
    (out (B,S,D), (c_kv (B,S,kv_lora), k_rope (B,S,rope)))."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _project_q(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _project_latent(p, x, cfg)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)

    k_nope = mm(c_kv, p.wuk).reshape(b, s, h, m.qk_nope_head_dim)
    v = mm(c_kv, p.wuv).reshape(b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)                          # (B,S,H,qk)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], -1)
    out = blockwise_attention(q, k, v, causal=True, block_q=block_q, block_kv=block_kv,
                              schedule=schedule, remat_tiles=cfg.attn_remat_tiles)
    return mm(merge_heads(out), p.wo), (c_kv, k_rope[:, :, 0, :])


def mla_decode(p: MLA, x: torch.Tensor, cfg, cache: dict, position: int) -> torch.Tensor:
    """Absorbed-matmul decode. x (B,1,D); cache = {'c_kv' (B,S,r),
    'k_rope' (B,S,rope)}, positions [0, ``position``] valid.

    scores_h(s) = q_nopeᵀ W_ukᵀ c_kv(s) + q_ropeᵀ k_rope(s)
    out_h       = W_uvᵀ (Σ_s p(s) · c_kv(s))
    """
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    f32 = torch.float32
    q_nope, q_rope = _project_q(p, x, cfg)                        # (B,1,H,·)
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    c_kv = cache["c_kv"].to(f32)
    wuk = p.wuk.reshape(m.kv_lora_rank, h, m.qk_nope_head_dim).to(f32)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32), wuk)   # (B,1,H,r)
    scores = torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv)
    scores = scores + torch.einsum("bqhn,bsn->bhqs", q_rope.to(f32),
                                   cache["k_rope"].to(f32))
    scores = scores * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    mask = torch.arange(c_kv.shape[1], device=x.device) <= position
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, -1)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)
    wuv = p.wuv.reshape(m.kv_lora_rank, h, m.v_head_dim).to(f32)
    out = torch.einsum("bqhr,rhv->bqhv", ctx_lat, wuv)
    return mm(out.to(x.dtype).reshape(b, 1, h * m.v_head_dim), p.wo)


def mla_new_cache_entry(p: MLA, x: torch.Tensor, cfg, position: int):
    """Latent cache line for the token(s) just processed. x (B,1,D)."""
    c_kv, k_rope = _project_latent(p, x, cfg)
    pos = torch.full(x.shape[:2], position, dtype=torch.int32, device=x.device)
    k_rope = apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope
