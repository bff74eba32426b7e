"""Mamba-2 (SSD, state-space duality): the chunked scan and the O(1) decode.

The counterpart of ``repro.models.mamba2``, which has no Pallas kernel:
its scan is plain einsums and a ``lax.scan``, so this port is plain
PyTorch too. Prefill and training run the SSD chunked algorithm: within a
chunk of Q positions the recurrence is a masked, decay-weighted
attention-like product; across the nc chunks a loop carries the
(G, Hg, N, P) state. Decode is the single-step recurrence against a
constant-size state and a (d_conv - 1)-position window of conv inputs,
both written in place.

Shapes: d_inner = expand·d_model, H = d_inner/headdim heads of dim P,
state size N, G groups sharing the B/C projections (Hg = H/G heads a
group). The SSD arithmetic is f32; the projections, the conv and the gated
norm's output run in the compute dtype.

Every product of the scan is a two-operand contraction in a fixed order
(the JAX package's three-operand einsums are split by hand), so the CPU
and the card contract alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import empty_param, mm, normal_, uniform_


def ssm_dims(cfg) -> tuple[int, int, int, int]:
    """(d_inner, H, conv_dim, d_in_proj) of ``cfg.ssm`` at ``cfg.d_model``."""
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + h
    return d_inner, h, conv_dim, d_in_proj


class Mamba2(nn.Module):
    """The mixer's parameters, the JAX leaves' names and shapes: ``in_proj``
    (D, 2·d_inner + 2·G·N + H), ``conv_w`` (d_conv, conv_dim), ``conv_b``,
    ``A_log``, ``D``, ``dt_bias`` (H,), ``gate_norm_scale`` (d_inner,) and
    ``out_proj`` (d_inner, D)."""

    def __init__(self, cfg, *, dtype, device=None):
        super().__init__()
        s = cfg.ssm
        d_inner, h, conv_dim, d_in_proj = ssm_dims(cfg)
        self.in_proj = empty_param((cfg.d_model, d_in_proj), dtype, device)
        self.conv_w = empty_param((s.d_conv, conv_dim), dtype, device)
        self.conv_b = empty_param((conv_dim,), dtype, device)
        self.A_log = empty_param((h,), dtype, device)
        self.D = empty_param((h,), dtype, device)
        self.dt_bias = empty_param((h,), dtype, device)
        self.gate_norm_scale = empty_param((d_inner,), dtype, device)
        self.out_proj = empty_param((d_inner, cfg.d_model), dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's inits: normal × fan_in^-½ for the matrices
        (``conv_w``'s fan-in is d_conv), zeros for ``conv_b`` and ``A_log``
        (A = -1), ones for ``D`` and the gate norm, U[0, 1) for ``dt_bias``."""
        normal_(self.in_proj, generator)
        normal_(self.conv_w, generator)
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.gate_norm_scale.fill_(1.0)
        uniform_(self.dt_bias, generator)
        normal_(self.out_proj, generator)


def _split_in_proj(zxbcdt: torch.Tensor, cfg):
    """-> z (.., d_inner), xbc (.., conv_dim), dt (.., H)."""
    s = cfg.ssm
    d_inner, h, _, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * gn],
            zxbcdt[..., -h:])


def _split_xbc(xbc: torch.Tensor, cfg):
    """-> xs (.., d_inner), B (.., G·N), C (.., G·N)."""
    s = cfg.ssm
    d_inner = ssm_dims(cfg)[0]
    gn = s.n_groups * s.d_state
    return xbc[..., :d_inner], xbc[..., d_inner:d_inner + gn], xbc[..., d_inner + gn:]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, then SiLU. x (B, L, C), w (K, C), b (C,).

    A cross-correlation, as ``lax.conv_general_dilated``: out[t] =
    Σ_k x[t - K + 1 + k]·w[k] over the zero-padded past, so the kernel is
    not flipped."""
    k = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))                   # (B, C, L + K - 1)
    out = F.conv1d(xp, w.T[:, None, :].to(x.dtype), groups=x.shape[-1]).transpose(1, 2)
    return F.silu(out + b.to(out.dtype))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float):
    """RMSNorm of y·silu(z): the product in y's dtype, the norm in f32."""
    yf = (y * F.silu(z)).to(torch.float32)
    out = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    return (out * scale.to(torch.float32)).to(y.dtype)


def ssd_scan(xs, dt, a, b_, c_, chunk: int, h_init=None):
    """The SSD chunked recurrence.

    xs (B, L, H, P) f32; dt (B, L, H) f32 (after the softplus); a (H,)
    negative; b_/c_ (B, L, G, N) f32. Returns (y (B, L, H, P),
    h_final (B, G, Hg, N, P)). L must be a multiple of Q = min(chunk, L).
    """
    bsz, l, h, p = xs.shape
    g, n = b_.shape[-2:]
    hg = h // g
    q = min(chunk, l)
    assert l % q == 0, (l, q)
    nc = l // q

    xs = xs.reshape(bsz, nc, q, g, hg, p)
    dt = dt.reshape(bsz, nc, q, g, hg)
    b_ = b_.reshape(bsz, nc, q, g, n)
    c_ = c_.reshape(bsz, nc, q, g, n)

    cs = torch.cumsum(dt * a.reshape(g, hg), dim=2)        # (B,nc,Q,G,Hg) inclusive

    # ---- intra-chunk: y[q] = Σ_{k≤q} (C_q·B_k) e^{cs_q - cs_k} dt_k x_k ----
    cb = torch.einsum("bcqgn,bckgn->bcgqk", c_, b_)       # (B,nc,G,Q,Q)
    # masked to -inf before the exp: above the diagonal cs_q - cs_k > 0 and
    # reaches e^88 (f32's limit) within a long chunk; masking after the exp
    # gives the same forward but a 0·inf = NaN gradient there
    tri = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    seg = torch.where(tri[:, :, None, None], cs[:, :, :, None] - cs[:, :, None],
                      float("-inf"))
    decay = torch.exp(seg)                                 # (B,nc,Q,Q,G,Hg)
    w = cb.permute(0, 1, 3, 4, 2)[..., None] * decay       # (B,nc,Q,Q,G,Hg)
    dtx = dt[..., None] * xs                               # (B,nc,Q,G,Hg,P)
    y_intra = torch.einsum("bcqkgh,bckghp->bcqghp", w, dtx)

    # ---- chunk states: Σ_q B_q e^{cs_end - cs_q} dt_q x_q ----
    decay_to_end = torch.exp(cs[:, :, -1:] - cs)           # (B,nc,Q,G,Hg)
    wx = (dt * decay_to_end)[..., None] * xs               # (B,nc,Q,G,Hg,P)
    states = torch.einsum("bcqgn,bcqghp->bcghnp", b_, wx)  # (B,nc,G,Hg,N,P)

    # ---- inter-chunk: the state entering each chunk ----
    t_total = torch.exp(cs[:, :, -1])                      # (B,nc,G,Hg)
    h_prev = (torch.zeros((bsz, g, hg, n, p), dtype=torch.float32, device=xs.device)
              if h_init is None else h_init)
    h_ins = []
    for c in range(nc):
        h_ins.append(h_prev)
        h_prev = h_prev * t_total[:, c, :, :, None, None] + states[:, c]
    h_ins = torch.stack(h_ins, 1)                          # (B,nc,G,Hg,N,P)

    y_inter = torch.einsum("bcqgn,bcghnp->bcqghp", c_, h_ins) * torch.exp(cs)[..., None]
    return (y_intra + y_inter).reshape(bsz, l, h, p), h_prev


def mamba_block(p: Mamba2, x: torch.Tensor, cfg, wsc=None, h_init=None,
                return_state: bool = False):
    """The Mamba-2 mixer. x (B, L, D) -> (B, L, D); with ``return_state``
    also (h_final (B, G, Hg, N, P) f32, conv_tail (B, d_conv - 1, conv_dim)),
    the decode cache of the last position: the SSD state and the conv's
    last pre-conv inputs."""
    wsc = wsc or (lambda a, _: a)
    s = cfg.ssm
    d_inner, h, _, _ = ssm_dims(cfg)
    bsz, l, _ = x.shape

    z, xbc, dt = _split_in_proj(mm(x, p.in_proj), cfg)
    conv_tail = xbc[:, -(s.d_conv - 1):]
    xs, b_, c_ = _split_xbc(causal_conv(xbc, p.conv_w, p.conv_b), cfg)

    xs = wsc(xs.reshape(bsz, l, h, s.headdim), "blhp").to(torch.float32)
    b_ = b_.reshape(bsz, l, s.n_groups, s.d_state).to(torch.float32)
    c_ = c_.reshape(bsz, l, s.n_groups, s.d_state).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias.to(torch.float32))
    a = -torch.exp(p.A_log.to(torch.float32))

    y, h_final = ssd_scan(xs, dt, a, b_, c_, s.chunk, h_init=h_init)
    y = y + p.D.to(torch.float32)[None, None, :, None] * xs
    y = _gated_norm(y.to(x.dtype).reshape(bsz, l, d_inner), z, p.gate_norm_scale,
                    cfg.norm_eps)
    out = mm(y, p.out_proj)
    if return_state:
        return out, (h_final, conv_tail)
    return out


def mamba_decode_step(p: Mamba2, x: torch.Tensor, cfg, ssm_state: torch.Tensor,
                      conv_cache: torch.Tensor):
    """One token's recurrence. x (B, 1, D); ssm_state (B, G, Hg, N, P) f32;
    conv_cache (B, d_conv - 1, conv_dim). Both are written in place (the
    state decayed and updated, the window shifted by one); returns
    (out (B, 1, D), ssm_state, conv_cache)."""
    s = cfg.ssm
    d_inner, h, _, _ = ssm_dims(cfg)
    g, hg = s.n_groups, h // s.n_groups
    bsz = x.shape[0]

    z, xbc, dt = _split_in_proj(mm(x, p.in_proj), cfg)
    window = torch.cat([conv_cache, xbc], dim=1)                        # (B, d_conv, C)
    # the conv's K products summed in f32 and rounded once, as a dot
    conv = (window.to(torch.float32) * p.conv_w.to(torch.float32)).sum(1).to(window.dtype)
    conv = F.silu(conv + p.conv_b.to(conv.dtype))[:, None, :]
    conv_cache.copy_(window[:, 1:])

    xs, b_, c_ = _split_xbc(conv, cfg)
    xs = xs.reshape(bsz, g, hg, s.headdim).to(torch.float32)
    b_ = b_.reshape(bsz, g, s.d_state).to(torch.float32)
    c_ = c_.reshape(bsz, g, s.d_state).to(torch.float32)
    dt = F.softplus(dt[:, 0].to(torch.float32) + p.dt_bias.to(torch.float32))
    dt = dt.reshape(bsz, g, hg)
    a = -torch.exp(p.A_log.to(torch.float32)).reshape(g, hg)

    decay = torch.exp(dt * a[None])                                     # (B,G,Hg)
    upd = b_[:, :, None, :, None] * (dt[..., None] * xs)[:, :, :, None, :]
    ssm_state.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bgn,bghnp->bghp", c_, ssm_state)
    y = y + p.D.to(torch.float32).reshape(g, hg)[None, ..., None] * xs
    y = _gated_norm(y.to(x.dtype).reshape(bsz, 1, d_inner), z, p.gate_norm_scale,
                    cfg.norm_eps)
    return mm(y, p.out_proj), ssm_state, conv_cache
