"""Mixture-of-Experts layer: local sort-based capacity dispatch.

The counterpart of ``repro.models.moe``. Dispatch is computed per batch
row (GShard-style groups = batch rows), batched over B, and never crosses
rows. Per row of S tokens: flatten the (S, k) assignments, stable-argsort
them by expert id, rank each assignment within its expert by a prefix
count, drop beyond capacity C = int(cf·S·k/E) + 1, lay the kept tokens
into an (E, C, D) buffer, run the expert FFNs as three batched products,
and weight the results back.

The router's expert-choice counts (E,) feed the Space Saving expert sketch
(``train/sketch.py:update_expert_sketch``).

On a mesh (``x`` a DTensor, its batch rows sharded) the router's top-k, the
dispatch and the combine run on each rank's own rows as plain tensors
(:class:`_LocalRows`), the counterpart of JAX's ``vmap`` over B: no index
tensor becomes a DTensor and no rank sorts another rank's rows. The expert
products stay DTensor einsums in the placements of ``wsc(buf, "becd")`` and
``wsc(h, "becf")``; the combine takes every expert's output rows for its
own batch rows back (``out_buf`` redistributed to the batch placements: an
all-gather over ``model`` under ``ep``, the reduction of a partial sum under
``tp``). ``expert_counts`` and the aux loss are over the global batch, as
JAX's are: each rank's (B_local, E) counts are summed over the mesh.

Every float sum here has a fixed order, so a step gives the same bits on
every run, its backward included. The JAX package scatters the tokens into
the buffer and adds the k contributions back with ``.at[token].add``; here
both directions are gathers through permutations (each kept assignment
owns one buffer slot), and the k contributions of a token are laid out as
(S, k, D) and summed over k. ``index_add_`` and the backward of a gather
with repeated indices would add with atomics on a card, in an order that
varies from run to run. The top-k keeps the lower expert index first on
tied probabilities, as ``lax.top_k`` does: a stable descending sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import empty_param, mm, normal_, whole_on


class MoE(nn.Module):
    """``router`` (D, E), ``w_gate`` and ``w_up`` (E, D, F), ``w_down``
    (E, F, D): the JAX layout."""

    def __init__(self, cfg, *, dtype, device=None):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
        self.router = empty_param((d, e), dtype, device)
        self.w_gate = empty_param((e, d, f), dtype, device)
        self.w_up = empty_param((e, d, f), dtype, device)
        self.w_down = empty_param((e, f, d), dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            normal_(p, generator)


def capacity(cfg, s: int) -> int:
    """Slots per expert for a row of ``s`` tokens."""
    m = cfg.moe
    return int(m.capacity_factor * s * m.top_k / m.n_experts) + 1


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last dim, lower
    index first among equal values (``lax.top_k``'s order)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def dispatch(top_e: torch.Tensor, cap: int, e: int):
    """The dispatch of every row. top_e (B, S, k) integer expert ids ->
    (slot, token_of, keep, order, counts), each (B, S·k) but counts (B, E):

      * ``order``: the stable argsort of the row's flat assignments by expert;
      * ``slot``: the buffer slot of the i-th sorted assignment,
        expert·cap + its rank within the expert, or e·cap where it is
        dropped (rank ≥ cap);
      * ``token_of``: its token (order // k); ``keep``: rank < cap;
      * ``counts``: assignments per expert (int32), drops included.
    """
    b, s, k = top_e.shape
    flat_e = top_e.reshape(b, s * k).long()
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=top_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(-1) - counts
    rank = torch.arange(s * k, device=top_e.device) - starts.gather(1, sorted_e)
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    return slot, order // k, keep, order, counts.to(torch.int32)


def _dispatch_one(xt: torch.Tensor, top_e: torch.Tensor, cap: int, e: int):
    """One row's dispatch, JAX's ``_dispatch_one``. xt (S, D); top_e (S, k)
    -> (buf (E·C, D), slot, token_of, keep, order, counts)."""
    slot, token_of, keep, order, counts = dispatch(top_e[None], cap, e)
    buf = _gather_rows(_sorted_rows(xt[None], order, top_e.shape[-1]), slot, e * cap)
    return buf[0], slot[0], token_of[0], keep[0], order[0], counts[0]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D) rows picked by idx (B, M) -> (B, M, D)."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _sorted_rows(x: torch.Tensor, order: torch.Tensor, k: int) -> torch.Tensor:
    """Each assignment's token row, in sorted order: x (B, S, D) -> (B, S·k, D).
    The token's k copies are an expand (its backward sums over k); the
    sort is a permutation."""
    b, s, d = x.shape
    return _rows(x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d), order)


def _gather_rows(rows: torch.Tensor, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The (B, n_slots, D) buffer whose slot ``slot[b, i]`` holds ``rows[b, i]``
    (kept slots are distinct); every other slot holds zeros."""
    b, m, d = rows.shape
    src = torch.full((b, n_slots + 1), m, dtype=torch.long, device=rows.device)
    src.scatter_(1, slot, torch.arange(m, device=rows.device).expand(b, m))
    padded = torch.cat([rows, rows.new_zeros((b, 1, d))], 1)
    return _rows(padded, src[:, :n_slots])


class _LocalRows:
    """Each rank's own batch rows of DTensors laid out as ``x`` (B, ...):
    ``local`` redistributes a tensor to the batch placements (its rows
    sharded as ``x``'s, every other dim whole) and returns the rank's rows;
    ``lift`` makes such rows a DTensor again; ``total`` sums rows over the
    whole batch. For a plain ``x`` (no mesh) each is the identity or a plain
    sum. ``to_local`` and ``from_local`` carry gradients."""

    def __init__(self, x: torch.Tensor):
        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        if self.mesh is not None:
            self.placements = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                               for p in x.placements]

    def local(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        return t.redistribute(self.mesh, self.placements).to_local()

    def lift(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh, self.placements, run_check=False)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """(B, E) int rows -> (E,) int32, summed over every rank's rows (a
        replicated DTensor on a mesh)."""
        out = self.lift(t).sum(0, dtype=torch.int32)
        if self.mesh is None:
            return out
        return out.redistribute(self.mesh, [Replicate()] * self.mesh.ndim)


def moe_layer(p: MoE, x: torch.Tensor, cfg, wsc=None):
    """x (B,S,D) -> (y (B,S,D), aux {'expert_counts' (E,) int32, 'aux_loss'}).

    The load-balance loss is the Switch/GShard one over the whole batch:
    E · Σ_e mean_prob_e · share_e · ``aux_loss_coef``.
    """
    wsc = wsc or (lambda a, _: a)
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = capacity(cfg, s)
    rows = _LocalRows(x)

    logits = mm(x, p.router).to(torch.float32)                   # (B,S,E)
    probs = torch.softmax(logits, -1)
    top_p, top_e = top_k(rows.local(probs), k)                    # (B_local,S,k)
    if m.router_norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)

    me = probs.mean(dim=(0, 1))                                   # (E,)
    slot, _, keep, order, counts = dispatch(top_e, cap, e)
    counts_all = rows.total(counts)
    ce = counts_all.to(torch.float32) / (b * s * k)
    aux_loss = e * (me * ce).sum() * m.aux_loss_coef

    xl = rows.local(x)
    bl = xl.shape[0]
    buf = _gather_rows(_sorted_rows(xl, order, k), slot, e * cap)  # (B_local, E·C, D)
    buf = wsc(rows.lift(buf.reshape(bl, e, cap, d)), "becd")
    # each expert weight whole on its embed dim (FSDP's gather before use):
    # left sharded there, on the mesh dim that shards the batch, DTensor's
    # einsum strategy makes a local view torch refuses; gathered, its
    # backward reduce-scatters the gradient into the weight's placements
    w_gate, w_up, w_down = (whole_on(w.to(x.dtype), dim)
                            for w, dim in ((p.w_gate, 1), (p.w_up, 1), (p.w_down, 2)))
    h = F.silu(torch.einsum("becd,edf->becf", buf, w_gate))
    h = h * torch.einsum("becd,edf->becf", buf, w_up)
    h = wsc(h, "becf")
    out_buf = torch.einsum("becf,efd->becd", h, w_down)
    out_buf = rows.local(out_buf).reshape(bl, e * cap, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((bl, 1, d))], 1)

    # every sorted assignment's result (dropped ones read the zero row),
    # weighted, then put back in (token, choice) order and summed over k
    w = top_p.to(x.dtype).reshape(bl, s * k).gather(1, order)
    contrib = _rows(out_buf, slot) * torch.where(keep, w, 0.0)[..., None].to(x.dtype)
    inverse = torch.argsort(order, dim=-1)
    y = _rows(contrib, inverse).reshape(bl, s, k, d).sum(2)
    return rows.lift(y), {"expert_counts": counts_all, "aux_loss": aux_loss}
