"""Attention: a blockwise (flash-style) prefill path and a cached decode path.

The counterpart of ``repro.models.attention``, in the same f32 arithmetic:
every score, softmax and value sum is f32, masked with ``NEG_INF = -1e30``,
and the outputs are cast back to ``q.dtype``. ``F.scaled_dot_product_attention``
is not used: its arithmetic is not the JAX package's, which the tests hold
these functions against.

The prefill path is an online softmax over (q-block, kv-block) tiles, so the
working set is one (Bq × Bkv) score tile, never the S×S matrix. Two block
schedules give the same outputs:

  * ``schedule='masked'``: every kv block is visited for every q block and
    masked;
  * ``schedule='band'``: only the (q, kv) pairs inside the causal /
    sliding-window band.

Layouts: prefill takes FLAT heads, q (B,S,H,hd), with K/V (B,S,KV,hd)
repeated group-wise inside each tile; decode is GROUPED, the
(B,S,KV,hd) cache is never repeated. On a mesh, :func:`local_heads` runs a
prefill attention on each rank's heads, which may split unevenly
(``torch.chunk``'s pieces; GSPMD pads instead): :func:`split_heads` and
:func:`merge_heads` make a projection whole on its last dim when the mesh
would cut it into pieces that are not whole heads, and the decode's
softmax is spelled out (:func:`softmax_parts`) so that a sequence-sharded
cache is never gathered.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.hlo_analysis import uniform_loop
from repro_torch.models.layers import empty_param, grad_as_placed, mm, normal_, whole_on

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _head_mask(cfg, device=None) -> torch.Tensor:
    """(Hp·hd,) mask — 1 for real q-head slots, 0 for per-group pads."""
    g_real = cfg.n_heads // cfg.n_kv_heads
    gp = g_real + cfg.q_head_pad
    m = torch.zeros((cfg.n_kv_heads, gp, cfg.hd), dtype=torch.float32, device=device)
    m[:, :g_real, :] = 1.0
    return m.reshape(-1)


def mask_pad_heads(out: torch.Tensor, cfg) -> torch.Tensor:
    """Zero the padded heads' attention output (B,S,Hp,hd)."""
    if not cfg.q_head_pad:
        return out
    mask = _head_mask(cfg, out.device).reshape(cfg.n_q_heads, cfg.hd)
    return out * mask[None, None].to(out.dtype)


class Attention(nn.Module):
    """The q/k/v/o projections (and QKV biases) of one attention block.

    ``wq`` holds ``cfg.n_q_heads`` heads, the ``q_head_pad`` zero pads of
    each KV group included; ``init_weights`` zeroes their wq columns and wo
    rows, as the JAX package does.
    """

    def __init__(self, cfg, *, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.hd
        hq, kv = cfg.n_q_heads, cfg.n_kv_heads
        self.wq = empty_param((d, hq * hd), dtype, device)
        self.wk = empty_param((d, kv * hd), dtype, device)
        self.wv = empty_param((d, kv * hd), dtype, device)
        self.wo = empty_param((hq * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = empty_param((hq * hd,), dtype, device)
            self.bk = empty_param((kv * hd,), dtype, device)
            self.bv = empty_param((kv * hd,), dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        hq = cfg.n_q_heads
        normal_(self.wq, generator)
        normal_(self.wk, generator)
        normal_(self.wv, generator)
        normal_(self.wo, generator,
                scale=(hq * cfg.hd) ** -0.5 / math.sqrt(2 * cfg.n_layers))
        with torch.no_grad():
            if cfg.q_head_pad:
                mask = _head_mask(cfg, self.wq.device).to(self.wq.dtype)
                self.wq.mul_(mask[None, :])
                self.wo.mul_(mask[:, None])
            if cfg.qkv_bias:
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()


def project_qkv(p: Attention, x: torch.Tensor, cfg, x_kv=None):
    """x (B,S,D) -> q (B,S,Hp,hd) flat (incl. pads), k/v (B,Skv,KV,hd)."""
    b, s, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    s_kv = x_kv.shape[1]
    hq, kv, hd = cfg.n_q_heads, cfg.n_kv_heads, cfg.hd
    q = mm(x, p.wq)
    k = mm(x_kv, p.wk)
    v = mm(x_kv, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + p.bk.to(k.dtype)
        v = v + p.bv.to(v.dtype)
    return split_heads(q, hq, hd), split_heads(k, kv, hd), split_heads(v, kv, hd)


def _shards(t: DTensor, dim: int) -> int:
    """How many pieces the mesh cuts dim ``dim`` of ``t`` into."""
    return math.prod(n for n, p in zip(t.device_mesh.shape, t.placements)
                     if isinstance(p, Shard) and p.dim == dim)


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n·hd) -> (..., n, hd): a projection (B, S, n·hd), or a weight
    (r, n·hd) (MLA's ``wuk``/``wuv``). A DTensor whose last dim the mesh
    cuts into pieces that are not whole heads (n not a multiple of the
    pieces: whisper's 6 heads, or minicpm3-4b's 40, on a ``model`` axis of
    4 or 16) is made whole there first: DTensor cannot unflatten such a
    dim. GSPMD pads the heads instead. The whole dim is split on each
    rank's local tensor: DTensor's own reshape views the local tensor, and
    its backward views the gradient, which a rank with no head of an MLA
    attention gets as a slice of a concatenation, where no view exists."""
    last = t.dim() - 1
    shape = (*t.shape[:-1], n, hd)
    if isinstance(t, DTensor) and n % _shards(t, last):
        w = whole_on(t, last)
        local = w.to_local()
        return DTensor.from_local(local.reshape(*local.shape[:-1], n, hd), w.device_mesh,
                                  w.placements, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())
    return t.reshape(shape)


# ---------------------------------------------------------------------------
# Blockwise attention (prefill)
# ---------------------------------------------------------------------------

def _pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target."""
    if n <= target:
        return n
    for b in range(target, 0, -1):
        if n % b == 0:
            return b
    return n


def _repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B,C,KV,hd) -> (B,C,KV*g,hd) by group-wise repetition."""
    return x if g == 1 else x.repeat_interleave(g, dim=2)


def _tile(q_blk, k_blk, v_blk, q_pos, kv_pos, causal, window, scale, g):
    """One (Bq × Bkv) online-softmax tile. Returns (m, l, acc) partials."""
    k_rep = _repeat_kv(k_blk, g).to(torch.float32)
    v_rep = _repeat_kv(v_blk, g).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk.to(torch.float32), k_rep) * scale
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    m = s.amax(-1)                                            # (B,H,q)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v_rep)
    return m, l, acc


def _merge_tiles(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def _band_pairs(nq, nkv, block_q, block_kv, *, causal, window, q_offset):
    """The (qi, ki) tiles inside the causal / sliding-window band, in order."""
    off_blocks = q_offset // block_q if q_offset else 0
    pairs = []
    for qi in range(nq):
        hi = qi + off_blocks if causal else nkv - 1
        lo = 0
        if window is not None:
            lo = max(0, (qi * block_q + q_offset - window) // block_kv)
        for ki in range(lo, min(hi, nkv - 1) + 1):
            pairs.append((qi, ki))
    return pairs


def blockwise_attention(q, k, v, *, causal=True, window=None, block_q=512,
                        block_kv=512, q_offset=0, schedule="masked", remat_tiles=False):
    """q (B,Sq,H,hd); k,v (B,Skv,KV,hd) -> out (B,Sq,H,hd_v).

    ``q_offset`` positions the query block within the kv sequence (for
    chunked prefill). Blocks are the largest divisors of the sequence
    lengths up to ``block_q``/``block_kv``. ``remat_tiles``: checkpoint each
    (q, kv) tile, so the backward recomputes a tile's scores instead of
    keeping every tile's (the same function; only memory and recompute
    change).
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = h // kvh
    block_q = _pick_block(sq, block_q)
    block_kv = _pick_block(skv, block_kv)
    nq, nkv = sq // block_q, skv // block_kv
    scale = hd ** -0.5
    dev = q.device
    if schedule == "band":
        if block_q != block_kv or q_offset % block_q:
            raise ValueError("the band schedule needs block_q == block_kv and a "
                             "q_offset that is a multiple of the block")
        pairs = _band_pairs(nq, nkv, block_q, block_kv, causal=causal,
                            window=window, q_offset=q_offset)
    elif schedule == "masked":
        pairs = [(qi, ki) for qi in range(nq) for ki in range(nkv)]
    else:
        raise ValueError(f"schedule {schedule!r} not in ('masked', 'band')")

    tile = _tile
    if remat_tiles and torch.is_grad_enabled():
        tile = functools.partial(checkpoint, _tile, use_reentrant=False)
    carry = {qi: (torch.full((b, h, block_q), NEG_INF, dtype=torch.float32, device=dev),
                  torch.zeros((b, h, block_q), dtype=torch.float32, device=dev),
                  torch.zeros((b, h, block_q, hd_v), dtype=torch.float32, device=dev))
             for qi in range(nq)}
    # every tile is (block_q × block_kv): the trips are uniform, and each
    # frees its temporaries before the next (one statement)
    for qi, ki in uniform_loop(pairs, q, k, v):
        carry[qi] = _merge_tiles(*carry[qi], *tile(
            q[:, qi * block_q:(qi + 1) * block_q], k[:, ki * block_kv:(ki + 1) * block_kv],
            v[:, ki * block_kv:(ki + 1) * block_kv],
            q_offset + qi * block_q + torch.arange(block_q, device=dev),
            ki * block_kv + torch.arange(block_kv, device=dev), causal, window, scale, g))
    outs = [acc / torch.clamp(l, min=1e-30)[..., None]          # (B,H,bq,hd_v)
            for _, l, acc in (carry[qi] for qi in range(nq))]
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)  # (B,Sq,H,hd_v)


# ---------------------------------------------------------------------------
# Decode attention (one new token against a cache)
# ---------------------------------------------------------------------------

def softmax_parts(scores: torch.Tensor) -> torch.Tensor:
    """``softmax(scores, -1)`` spelled out (max, exp, sum, divide). With
    the last dim sharded (a DTensor over a sequence-parallel cache) each
    rank works on its own positions and only the max and the sum cross
    the mesh; ``torch.softmax`` over a sharded dim would gather the
    scores."""
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """q (B,1,H,hd); caches (B,S,KV,hd); ``cache_len`` valid positions.

    GROUPED einsum (no KV repeat): decode is bandwidth-bound on the cache
    read, so its bytes stay at true-GQA levels. On a mesh (q whole on its
    heads, the caches' sequence sharded) the softmax is taken in parts
    (:func:`softmax_parts`) and the output's partial sum is reduced over
    the sequence's shards: neither the cache nor its scores move.
    """
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    s = k_cache.shape[1]
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqKGh,bkKh->bKGqk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * hd ** -0.5
    pos = torch.arange(s, device=q.device)
    mask = pos < cache_len
    if window is not None:
        mask &= pos >= cache_len - window
    scores = torch.where(mask, scores, NEG_INF)
    p = softmax_parts(scores) if isinstance(scores, DTensor) else torch.softmax(scores, -1)
    out = torch.einsum("bKGqk,bkKh->bqKGh", p, v_cache.to(torch.float32))
    return out.to(q.dtype).reshape(b, 1, h, v_cache.shape[-1])


def decode_attention_plus_one(q, k_cache, v_cache, k_new, v_new, position, *,
                              window=None):
    """Decode attention where the NEW token's kv is supplied separately.

    The cache is read-only (positions < ``position``); the current token's
    (k_new, v_new) (B,1,KV,hd) is merged into the softmax analytically, so
    the decode step writes all layers' cache slices once, after its layer
    loop.
    """
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    s = k_cache.shape[1]
    qg = q.reshape(b, 1, kvh, g, hd).to(torch.float32)
    scale = hd ** -0.5
    s_old = torch.einsum("bqKGh,bkKh->bKGqk", qg, k_cache.to(torch.float32)) * scale
    pos = torch.arange(s, device=q.device)
    mask = pos < position                       # strictly old positions
    if window is not None:
        mask &= pos > position - window
    s_old = torch.where(mask, s_old, NEG_INF)
    s_new = torch.einsum("bqKGh,bkKh->bKGqk", qg,
                         k_new.to(torch.float32)) * scale     # (B,KV,G,1,1)
    m = torch.maximum(s_old.amax(-1, keepdim=True), s_new)
    p_old = torch.where(mask, torch.exp(s_old - m), 0.0)
    p_new = torch.exp(s_new - m)
    denom = p_old.sum(-1, keepdim=True) + p_new
    out = torch.einsum("bKGqk,bkKh->bqKGh", p_old, v_cache.to(torch.float32))
    out = out + p_new.reshape(b, 1, kvh, g, 1) * v_new.to(torch.float32)[:, :, :, None, :]
    out = out / denom.reshape(b, 1, kvh, g, 1)
    return out.to(q.dtype).reshape(b, 1, h, v_cache.shape[-1])


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` (an attention over (B,S,H,hd) q and (B,S,KV,hd) k/v)
    on each rank's batch rows and heads. k and v are repeated to q's heads
    (the values ``fn``'s own group-wise repeat makes) and laid out as q is,
    so every rank pairs its q heads with their kv heads; then ``fn`` runs
    on the local tensors, and the output takes q's placements; where the
    heads split unevenly (``torch.chunk``'s pieces) it is given its global
    shape, which DTensor would infer as an even split's. DTensor cannot run the attention's products itself: they
    flatten (batch, heads) into one dim while the heads are sharded, which
    it refuses."""
    g = q.shape[2] // k.shape[2]
    mesh, pl = q.device_mesh, q.placements
    k, v = (_repeat_kv(t, g).redistribute(mesh, pl) for t in (k, v))
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if ql.shape[2]:
        out = fn(ql, kl, vl)
    else:
        # torch.chunk leaves this rank no head (6 heads on 4: 2, 2, 2, 0):
        # an empty output, still tied to q, k and v, so that the backward
        # runs their redistributions' collectives on this rank too
        out = (ql.sum() + kl.sum() + vl.sum()) + ql.new_zeros((*ql.shape[:3], vl.shape[-1]))
    if q.shape[2] % _shards(q, 2) == 0:     # even heads: the shape DTensor infers
        return DTensor.from_local(out, mesh, pl, run_check=False)
    shape = (*q.shape[:3], out.shape[-1])
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,H*hd); heads that a mesh splits unevenly are made
    whole first (DTensor cannot flatten them), and so are the heads of a
    partial sum (MLA's decode output, summed over the sequence's shards)
    that DTensor would reduce-scatter onto them unevenly."""
    if isinstance(x, DTensor):
        cut = [i for i, p in enumerate(x.placements)
               if (isinstance(p, Shard) and p.dim == 2) or p.is_partial()]
        if x.shape[2] % math.prod(x.device_mesh.shape[i] for i in cut):
            whole = [Replicate() if i in cut else p for i, p in enumerate(x.placements)]
            return grad_as_placed(x.redistribute(x.device_mesh, whole)
                                  .reshape(*x.shape[:2], -1))
    return x.reshape(*x.shape[:2], -1)
