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

On a mesh (DTensors; ``wsc`` the plan's) the parameters keep their
placements: ``in_proj``'s ``ssm_in`` columns, ``conv_w``/``conv_b``'s
channels and ``out_proj``'s ``ssm_inner`` rows on ``model``. The
``in_proj`` output is made whole on its last dim (``wsc(.., "bsx")``, an
all-gather) before it is split at d_inner: the split cuts through a
``model`` shard. The conv runs on each rank's channels as plain tensors
(:func:`_on_mesh`, with ``conv_w``'s and ``conv_b``'s own shards) and its
output is gathered, since its xs | B | C split cuts through the channel
shards too. The scan runs on each rank's heads, or on its headdim columns
when ``ShardingPlan._ssm_spec`` shards P, with the B/C columns of the
groups its heads belong to (:func:`_scan_on_mesh`): it is independent per
head and per column, so it needs no collective. DTensor reduces the gated
norm's mean over the sharded d_inner and ``out_proj``'s partial sum. A
prefill's final state leaves the scan with its heads flattened (a rank
may hold part of a group, which DTensor cannot unflatten) and is moved to
the cache's layout, P on ``model``, where it is made. The decode writes
each rank's shard of the state and the conv window in place, runs the
recurrence on its P columns and gathers only the (B, conv_dim) conv output
and the (B, d_inner) output: no tensor of a state's or window's shape
moves. Its conv weights are laid out on the window's channels, which
``cache_shardings`` keeps on ``model`` under ``no_tp`` too, where the
weights are replicated (a slice of each rank's copy).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import (empty_param, grad_as_placed, mm, normal_, uniform_,
                                       whole_on)


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


def _on_mesh(fn, out_placements, *args):
    """``fn(*args)`` on each rank's local shards of the DTensors ``args``
    (``(tensor, placements)`` pairs: each is first redistributed to its
    placements), the outputs DTensors of ``out_placements`` (a list for
    one output, a tuple of lists for several, as ``local_map`` takes
    them). An argument replicated on a mesh dim that shards the work takes
    a Partial gradient there: each rank uses it for its own rows, heads or
    columns only."""
    tensors = [t.redistribute(t.device_mesh, pl) for t, pl in args]
    split = [any(isinstance(pl[i], Shard) for _, pl in args)
             for i in range(tensors[0].device_mesh.ndim)]
    grads = [tuple(Partial() if isinstance(q, Replicate) and split[i] else q
                   for i, q in enumerate(pl)) for _, pl in args]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(tuple(pl) for _, pl in args),
                     in_grad_placements=tuple(grads),
                     device_mesh=tensors[0].device_mesh)(*tensors)


def _shard_as(pl, dims: dict) -> list:
    """``pl`` with every ``Shard(d)`` moved to ``Shard(dims[d])`` (or made
    ``Replicate()`` where ``dims[d]`` is None); a ``Shard(d)`` whose d is
    not a key stays."""
    out = []
    for q in pl:
        if isinstance(q, Shard) and q.dim in dims:
            q = Replicate() if dims[q.dim] is None else Shard(dims[q.dim])
        out.append(q)
    return out


def _mesh_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``causal_conv`` on each rank's channels: xbc (B, L, C) laid out on
    its channels as ``w``'s (K, C) are, then gathered whole on C."""
    chan = _shard_as(w.placements, {1: 2})
    pl = [q if isinstance(q, Shard) and q.dim == 0 else c
          for q, c in zip(xbc.placements, chan)]
    out = _on_mesh(causal_conv, pl, (xbc, pl), (w, w.placements), (b, b.placements))
    return whole_on(out, 2)


def _local_groups(h0: int, hl: int, hg: int):
    """The groups of a rank's heads [h0, h0 + hl) (``hg`` heads a group),
    as an index of the group dim: a slice when its heads are whole groups
    or part of one group, else (heads that straddle a group boundary
    unevenly) one group index a head."""
    gids = [(h0 + j) // hg for j in range(hl)]
    n = gids[-1] - gids[0] + 1
    if hl % n == 0 and gids == [gids[0] + j // (hl // n) for j in range(hl)]:
        return slice(gids[0], gids[-1] + 1)
    return gids


def _scan_on_mesh(xs, dt, a, b_, c_, chunk: int):
    """:func:`ssd_scan` on each rank's heads or headdim columns (xs's
    ``blhp`` placements), with the B/C columns of the groups its heads
    belong to -> (y in xs's placements, h_final (B, H, N, P) with the heads
    flattened)."""
    mesh, pl = xs.device_mesh, list(xs.placements)
    h, g = xs.shape[2], b_.shape[2]
    shape, off = compute_local_shape_and_global_offset(xs.shape, mesh, pl)
    groups = _local_groups(off[2], shape[2], h // g)

    def run(xs, dt, a, b_, c_):
        y, hf = ssd_scan(xs, dt, a, b_[:, :, groups], c_[:, :, groups], chunk)
        return y, hf.reshape(xs.shape[0], xs.shape[2], *hf.shape[-2:])

    heads = _shard_as(pl, {3: None})                      # (B, L, H) as xs's first dims
    batch = _shard_as(pl, {2: None, 3: None})
    return _on_mesh(run, (pl, _shard_as(pl, {2: 1})), (xs, pl), (dt, heads),
                    (a, _shard_as(heads, {0: None, 2: 0})), (b_, batch), (c_, batch))


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
    last pre-conv inputs. On a mesh (``x`` a DTensor) the conv and the scan
    run on each rank's shards (see the module docstring); ``h_init`` is
    then not taken."""
    wsc = wsc or (lambda a, _: a)
    s = cfg.ssm
    d_inner, h, _, _ = ssm_dims(cfg)
    bsz, l, _ = x.shape
    on_mesh = isinstance(x, DTensor)
    if on_mesh and h_init is not None:
        raise ValueError("mamba_block: h_init is not taken on a mesh")

    zxbcdt = mm(x, p.in_proj)
    if on_mesh:         # whole before the split, which cuts through a model shard
        zxbcdt = wsc(zxbcdt, "bsx")
    z, xbc, dt = _split_in_proj(zxbcdt, cfg)
    conv_tail = xbc[:, -(s.d_conv - 1):]
    conv = (_mesh_conv if on_mesh else causal_conv)(xbc, p.conv_w, p.conv_b)
    xs, b_, c_ = _split_xbc(conv, cfg)

    xs = wsc(xs.reshape(bsz, l, h, s.headdim), "blhp").to(torch.float32)
    b_ = b_.reshape(bsz, l, s.n_groups, s.d_state).to(torch.float32)
    c_ = c_.reshape(bsz, l, s.n_groups, s.d_state).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias.to(torch.float32))
    a = -torch.exp(p.A_log.to(torch.float32))

    if on_mesh:
        y, h_final = _scan_on_mesh(xs, dt, a, b_, c_, s.chunk)
        if return_state:    # to the cache's layout: P on model, then (G, Hg) whole
            h_final = h_final.redistribute(h_final.device_mesh,
                                           _shard_as(h_final.placements, {1: 3}))
            h_final = h_final.reshape(bsz, s.n_groups, h // s.n_groups, s.d_state,
                                      s.headdim)
    else:
        y, h_final = ssd_scan(xs, dt, a, b_, c_, s.chunk, h_init=h_init)
    y = y + p.D.to(torch.float32)[None, None, :, None] * xs
    if on_mesh:
        # a headdim-sharded y is made whole before its heads are flattened,
        # and its gradient comes back whole too (grad_as_placed): the
        # flatten's backward cannot take d_inner's shards, which would cut
        # the headdim unevenly
        y = grad_as_placed(whole_on(y, 3).reshape(bsz, l, d_inner))
    y = _gated_norm(y.to(x.dtype).reshape(bsz, l, d_inner), z, p.gate_norm_scale,
                    cfg.norm_eps)
    out = mm(y, p.out_proj)
    if return_state:
        return out, (h_final, conv_tail)
    return out


def _conv_step(conv_cache, xbc, w, b):
    """The conv of one new position: ``xbc`` (B, 1, C) after the window
    ``conv_cache`` (B, d_conv - 1, C), which shifts by one in place. The K
    products are summed in f32 and rounded once, as a dot; -> (B, 1, C)."""
    window = torch.cat([conv_cache, xbc], dim=1)                        # (B, d_conv, C)
    conv = (window.to(torch.float32) * w.to(torch.float32)).sum(1).to(window.dtype)
    conv_cache.copy_(window[:, 1:])
    return F.silu(conv + b.to(conv.dtype))[:, None, :]


def _state_step(ssm_state, xs, b_, c_, dt, a, d):
    """The recurrence of one position: ``ssm_state`` (B, G, Hg, N, P) f32
    decayed and updated in place; xs (B, G, Hg, P), b_/c_ (B, G, N), dt
    (B, G, Hg), a and d (G, Hg) f32 -> y (B, G, Hg, P)."""
    decay = torch.exp(dt * a[None])                                     # (B,G,Hg)
    upd = b_[:, :, None, :, None] * (dt[..., None] * xs)[:, :, :, None, :]
    ssm_state.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bgn,bghnp->bghp", c_, ssm_state)
    return y + d[None, ..., None] * xs


def mamba_decode_step(p: Mamba2, x: torch.Tensor, cfg, ssm_state: torch.Tensor,
                      conv_cache: torch.Tensor, wsc=None):
    """One token's recurrence. x (B, 1, D); ssm_state (B, G, Hg, N, P) f32;
    conv_cache (B, d_conv - 1, conv_dim). Both are written in place (the
    state decayed and updated, the window shifted by one); returns
    (out (B, 1, D), ssm_state, conv_cache). On a mesh (DTensors in
    ``cache_shardings``' layout) each rank writes its own shards: the conv
    on its channels, the recurrence on its P columns."""
    wsc = wsc or (lambda a, _: a)
    s = cfg.ssm
    d_inner, h, _, _ = ssm_dims(cfg)
    g, hg = s.n_groups, h // s.n_groups
    bsz = x.shape[0]
    on_mesh = isinstance(x, DTensor)

    zxbcdt = mm(x, p.in_proj)
    if on_mesh:
        zxbcdt = wsc(zxbcdt, "bsx")
    z, xbc, dt = _split_in_proj(zxbcdt, cfg)
    if on_mesh:
        # the weights laid out on the window's channels (a slice where they
        # are replicated, under no_tp), as _mesh_conv lays xbc out as w is
        win = list(conv_cache.placements)
        conv = whole_on(_on_mesh(_conv_step, win, (conv_cache, win), (xbc, win),
                                 (p.conv_w, _shard_as(win, {0: None, 1: None, 2: 1})),
                                 (p.conv_b, _shard_as(win, {0: None, 1: None, 2: 0}))), 2)
    else:
        conv = _conv_step(conv_cache, xbc, p.conv_w, p.conv_b)

    xs, b_, c_ = _split_xbc(conv, cfg)
    xs = xs.reshape(bsz, g, hg, s.headdim).to(torch.float32)
    b_ = b_.reshape(bsz, g, s.d_state).to(torch.float32)
    c_ = c_.reshape(bsz, g, s.d_state).to(torch.float32)
    dt = F.softplus(dt[:, 0].to(torch.float32) + p.dt_bias.to(torch.float32))
    dt = dt.reshape(bsz, g, hg)
    a = -torch.exp(p.A_log.to(torch.float32)).reshape(g, hg)
    d = p.D.to(torch.float32).reshape(g, hg)
    if on_mesh:         # each rank's P columns of the state; y gathered whole
        st = ssm_state.placements
        cols = _shard_as(st, {4: 3})                    # xs (B, G, Hg, P) as the state
        rows = _shard_as(st, {4: None})                 # batch only
        y = _on_mesh(_state_step, cols, (ssm_state, st), (xs, cols), (b_, rows),
                     (c_, rows), (dt, rows), (a, _shard_as(rows, {0: None})),
                     (d, _shard_as(rows, {0: None})))
        y = whole_on(y, 3)
    else:
        y = _state_step(ssm_state, xs, b_, c_, dt, a, d)
    y = _gated_norm(y.to(x.dtype).reshape(bsz, 1, d_inner), z, p.gate_norm_scale,
                    cfg.norm_eps)
    return mm(y, p.out_proj), ssm_state, conv_cache
