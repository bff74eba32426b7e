"""Model assembly for the decoder-only families: dense GQA (qwen2.5-14b,
yi-34b, qwen1.5-110b), MLA (minicpm3-4b) and MoE (qwen3-moe-30b-a3b,
mixtral-8x7b).

The counterpart of ``repro.models.model``'s dense branch (``_dense_layer``:
an MLA or a GQA attention with QKV bias, optional sliding window and
``q_head_pad``, then an MoE FFN or an MLP): one parameter construction
(:class:`DenseLM`, an ``nn.Module`` in the JAX layout), one forward over the
layer list, one cached :func:`decode_step`. The ssm, hybrid, audio and vlm
families raise ``NotImplementedError``: their modules are ROADMAP.md §1
item 3(b).

Weights come from a seeded ``torch.Generator`` with the JAX package's
scales (normal × fan_in^-½, ``embed`` 1.0, ``wo`` (hq·hd)^-½/√(2L), zero
biases, ones norms); the bits differ from JAX's threefry draws, so a test
that compares the two packages carries JAX's weights over with
``models/convert.py``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mla, moe
from repro_torch.models.layers import MLP, empty_param, make_norm, mm, normal_
from repro_torch.models.rope import apply_rope


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def check_family(cfg) -> None:
    """Raise unless ``cfg`` is of a family the port runs: dense (GQA or
    MLA attention) or moe."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP.md §1 "
            f"item 3(b)); the port runs the dense GQA, MLA and MoE families")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder layer: norm → attention → residual, norm → FFN → residual.

    ``attn`` is an :class:`~repro_torch.models.mla.MLA` when ``cfg.mla``
    is set, else a GQA :class:`~repro_torch.models.attention.Attention`;
    the FFN is ``moe`` (:class:`~repro_torch.models.moe.MoE`) when
    ``cfg.moe`` is set, else ``mlp``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = _dt(cfg)
        self.attn_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                   dtype=dt, device=device)
        self.attn = (mla.MLA(cfg, dtype=dt, device=device) if cfg.mla is not None
                     else attn.Attention(cfg, dtype=dt, device=device))
        self.mlp_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                  dtype=dt, device=device)
        if cfg.moe is not None:
            self.moe = moe.MoE(cfg, dtype=dt, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.attn_norm.init_weights()
        self.attn.init_weights(generator)
        self.mlp_norm.init_weights()
        (self.moe if hasattr(self, "moe") else self.mlp).init_weights(generator)


class DenseLM(nn.Module):
    """``embed`` (V, D), ``layers``, ``final_norm`` and ``lm_head`` (D, V),
    or the transposed embedding when ``cfg.tie_embeddings``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        dt = _dt(cfg)
        self.embed = empty_param((cfg.vocab, cfg.d_model), dt, device)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                    dtype=dt, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else empty_param((cfg.d_model, cfg.vocab), dt, device))

    def init_weights(self, generator: torch.Generator) -> None:
        normal_(self.embed, generator, scale=1.0)
        for block in self.layers:
            block.init_weights(generator)
        self.final_norm.init_weights()
        if self.lm_head is not None:
            normal_(self.lm_head, generator)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head


def build_params(cfg, device=None) -> DenseLM:
    """The model with its parameters allocated on ``device`` but not filled
    (``device="meta"``: shapes and dtypes only)."""
    return DenseLM(cfg, device=device)


def init_params(cfg, generator: torch.Generator, device=None) -> DenseLM:
    """A model on ``device`` (default: the generator's) with fresh weights."""
    model = build_params(cfg, generator.device if device is None else device)
    model.init_weights(generator)
    return model


def param_shapes(cfg) -> dict:
    """Every parameter as a ``meta`` tensor, keyed as the ``state_dict``."""
    return dict(build_params(cfg, "meta").state_dict())


def param_count(cfg, active_only: bool = False, include_embed: bool = False) -> int:
    """Parameters of the model (``embed``/``lm_head`` only if
    ``include_embed``), counted on the ``meta`` device. ``active_only``
    scales the expert stacks by top_k/E, by the JAX package's rule on its
    stacked layout: a leaf of 2 dims or more whose third dim from the end
    is n_experts."""
    from repro_torch.models.convert import stack_params
    tree = stack_params(cfg, param_shapes(cfg))
    leaves = [(n, t) for n, t in tree.items() if n != "layers"] + list(tree["layers"].items())
    total = 0
    for name, leaf in leaves:
        if not include_embed and name in ("embed", "lm_head"):
            continue
        size = leaf.numel()
        if active_only and cfg.moe is not None and leaf.dim() >= 2 \
                and tuple(leaf.shape[-3:-2]) == (cfg.moe.n_experts,):
            size = size * cfg.moe.top_k // cfg.moe.n_experts
        total += size
    return total


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


def _self_attention(block: Block, h, cfg, positions, wsc, *, schedule="masked"):
    q, k, v = attn.project_qkv(block.attn, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = wsc(q, "bshd"), wsc(k, "bskvh"), wsc(v, "bskvh")
    out = attn.blockwise_attention(q, k, v, causal=True, window=cfg.swa_window,
                                   schedule=schedule, remat_tiles=cfg.attn_remat_tiles)
    out = attn.mask_pad_heads(out, cfg)
    return mm(attn.merge_heads(wsc(out, "bshd")), block.attn.wo), (k, v)


def _dense_block(block: Block, x, cfg, positions, wsc, schedule="masked"):
    """-> (x, aux, kv): ``aux`` the MoE's {'expert_counts', 'aux_loss'} (or
    empty), ``kv`` the layer's cache entries ({'k', 'v'} or {'c_kv',
    'k_rope'})."""
    h = block.attn_norm(x)
    if cfg.mla is not None:
        a, (c_kv, k_rope) = mla.mla_prefill(block.attn, h, cfg, positions,
                                            schedule=schedule)
        kv = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        a, (k, v) = _self_attention(block, h, cfg, positions, wsc, schedule=schedule)
        kv = {"k": k, "v": v}
    x = x + a
    h = block.mlp_norm(x)
    if cfg.moe is not None:
        y, aux = moe.moe_layer(block.moe, h, cfg, wsc)
    else:
        y, aux = block.mlp(h, wsc), {}
    return x + y, aux, kv


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of the plain weight products
    (``aten.mm``: ``x @ w`` of an activation and a matrix), recompute the
    rest. The counterpart of ``dots_with_no_batch_dims_saveable``: the
    attention's and the experts' batched products (``bmm``) are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(f, policy: str | None = None):
    """``f`` under ``torch.utils.checkpoint`` (non-reentrant); with
    ``policy='dots'`` selective, saving what :func:`_save_dots` keeps."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return functools.partial(checkpoint, f, use_reentrant=False, **kw)


def _remat_layers(fns: list, x: torch.Tensor, remat: str):
    """Run the layer functions ``fns`` over ``x`` under the remat policy.

    Each function maps ``x`` to a tuple ``(x, *extras)``: the extras are
    tensors a layer yields beside its output (an MoE layer's expert counts
    and aux loss). Returns ``(x, [extras of each layer])``. The extras are
    outputs, not side effects, so a checkpoint's recompute in the backward
    counts nothing twice; a float extra carries its gradient through the
    checkpoint.

    The counterpart of the JAX package's ``_remat``/``_scan_layers``:
      * ``none``: autograd keeps every layer's activations;
      * ``full``: each layer is checkpointed (only its input is kept);
      * ``dots``: each layer is checkpointed selectively (:func:`_save_dots`);
      * ``nested:G``: one checkpoint over each group of G layers (G the
        largest divisor of L that is ≤ G; 8 without ``:G``), the layers
        inside checkpointed too: the backward keeps L/G group inputs and
        recomputes one group at a time.
    Every policy computes the same function; only memory and recompute move.
    """
    extras = []
    if remat in ("none", "full", "dots"):
        for f in fns:
            x, *rest = f(x) if remat == "none" else _checkpointed(f, remat)(x)
            extras.append(tuple(rest))
        return x, extras
    if remat.startswith("nested"):
        want = int(remat.split(":")[1]) if ":" in remat else 8
        n = len(fns)
        g = max(d for d in range(1, min(want, n) + 1) if n % d == 0)

        def group_fn(group):
            def run(h):
                flat = []
                for f in group:
                    h, *rest = _checkpointed(f)(h)
                    flat.extend(rest)
                return (h, *flat)
            return run

        for i in range(0, n, g):
            x, *flat = _checkpointed(group_fn(fns[i:i + g]))(x)
            per = len(flat) // g
            extras.extend(tuple(flat[j * per:(j + 1) * per]) for j in range(g))
        return x, extras
    raise ValueError(f"remat {remat!r} not in ('none', 'full', 'dots', 'nested:<G>')")


def forward(model: DenseLM, batch: dict, cfg, wsc=None, schedule="masked",
            collect=False):
    """batch: {'tokens' (B,S) [, 'positions' (B,S)]}.

    Returns (logits_f32 (B,S,V), aux dict). With ``collect=True`` (the
    serving *prefill* path) aux["cache"] holds the per-layer cache in the
    layout of :func:`cache_shapes` (max_len = S). Otherwise, with gradients
    on (training), the layers run under ``cfg.remat``
    (:func:`_remat_layers`). For the MoE family aux also holds
    ``expert_counts`` (E,) int32 and ``aux_loss``, each summed over the
    layers.
    """
    check_family(cfg)
    wsc = wsc or (lambda a, _: a)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(tokens)
    x = wsc(F.embedding(tokens, model.embed).to(_cdt(cfg)), "bsd")
    moe_aux, kvs = [], []
    if collect:
        for block in model.layers:
            x, aux_l, kv = _dense_block(block, x, cfg, positions, wsc, schedule)
            x = wsc(x, "bsd")
            moe_aux.append(aux_l)
            kvs.append({name: t.to(_cdt(cfg)) for name, t in kv.items()})
    else:
        def layer(block):
            def run(h):
                h, aux_l, _ = _dense_block(block, h, cfg, positions, wsc, schedule)
                return (wsc(h, "bsd"), *aux_l.values())
            return run
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        x, extras = _remat_layers([layer(b) for b in model.layers], x, remat)
        moe_aux = [dict(zip(("expert_counts", "aux_loss"), e)) for e in extras]
    x = model.final_norm(x)
    logits = wsc(mm(x, model.head()).to(torch.float32), "bsv")
    aux: dict = {}
    if cfg.moe is not None:
        aux.update(_sum_moe_aux(moe_aux))
    if collect:
        aux["cache"] = {name: torch.stack([kv[name] for kv in kvs]) for name in kvs[0]}
    return logits, aux


def _sum_moe_aux(per_layer: list) -> dict:
    """The layers' MoE aux summed: expert counts (E,) int32, the aux loss."""
    return {"expert_counts": torch.stack([a["expert_counts"] for a in per_layer])
            .sum(0, dtype=torch.int32),
            "aux_loss": torch.stack([a["aux_loss"] for a in per_layer]).sum()}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy (+ ``z_loss`` · mean lse²)."""
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (lse - label_logit).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def loss_fn(model: DenseLM, batch: dict, cfg, wsc=None, schedule="masked"):
    """Cross entropy, plus the MoE aux loss where the model has one."""
    logits, aux = forward(model, batch, cfg, wsc, schedule=schedule)
    loss = cross_entropy(logits, batch["labels"], cfg.z_loss)
    if "aux_loss" in aux:
        loss = loss + aux["aux_loss"]
    aux["ce_loss"] = loss
    return loss, aux


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg, batch_size: int, max_len: int) -> dict:
    """The decode cache as ``meta`` tensors: k, v (L, B, S, KV, hd); for
    MLA c_kv (L, B, S, kv_lora) and k_rope (L, B, S, rope)."""
    check_family(cfg)
    lead = (cfg.n_layers, batch_size, max_len)
    if cfg.mla is not None:
        shapes = {"c_kv": lead + (cfg.mla.kv_lora_rank,),
                  "k_rope": lead + (cfg.mla.qk_rope_head_dim,)}
    else:
        shapes = {name: lead + (cfg.n_kv_heads, cfg.hd) for name in ("k", "v")}
    return {name: torch.empty(shape, dtype=_cdt(cfg), device="meta")
            for name, shape in shapes.items()}


def init_cache(cfg, batch_size: int, max_len: int, device=None) -> dict:
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in cache_shapes(cfg, batch_size, max_len).items()}


def _decode_self_attention_ro(block: Block, h, cfg, k_cache, v_cache, position, wsc):
    """Read-only-cache decode attention: returns (out, k_new, v_new)."""
    b = h.shape[0]
    q, k_new, v_new = attn.project_qkv(block.attn, h, cfg)
    pos = torch.full((b, 1), position, dtype=torch.int32, device=h.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)
    out = attn.decode_attention_plus_one(
        q, wsc(k_cache, "bskh"), wsc(v_cache, "bskh"), k_new, v_new, position,
        window=cfg.swa_window)
    out = attn.mask_pad_heads(out, cfg)
    return mm(attn.merge_heads(out), block.attn.wo), k_new, v_new


def decode_step(model: DenseLM, cache: dict, tokens: torch.Tensor, position: int,
                cfg, wsc=None):
    """One decode step. tokens (B,1) -> (logits (B,1,V) f32, cache, aux).

    ``position`` is the index the new token occupies; attention spans
    positions [0, position]. The cache is written in place: the returned
    cache is ``cache``. GQA: the cache is read-only inside the layer loop;
    after it, one slice write per tensor puts every layer's new k/v at
    ``position``. MLA: each layer writes its latent line at ``position``,
    then attends over [0, position] in the absorbed form; its FFN is the
    dense MLP, as the JAX package's MLA branch runs it. For the MoE family
    aux holds ``expert_counts`` (E,) int32, summed over the layers.
    """
    check_family(cfg)
    wsc = wsc or (lambda a, _: a)
    x = F.embedding(tokens, model.embed).to(_cdt(cfg))
    aux: dict = {}
    if cfg.mla is not None:
        ck_all, kr_all = cache["c_kv"], cache["k_rope"]
        for i, block in enumerate(model.layers):
            hn = block.attn_norm(x)
            ckv_new, krope_new = mla.mla_new_cache_entry(block.attn, hn, cfg, position)
            ck_all[i, :, position:position + 1] = ckv_new.to(ck_all.dtype)
            kr_all[i, :, position:position + 1] = krope_new.to(kr_all.dtype)
            x = x + mla.mla_decode(block.attn, hn, cfg,
                                   {"c_kv": ck_all[i], "k_rope": kr_all[i]}, position)
            x = x + block.mlp(block.mlp_norm(x), wsc)
    else:
        k_news, v_news, moe_aux = [], [], []
        for i, block in enumerate(model.layers):
            a, k_new, v_new = _decode_self_attention_ro(
                block, block.attn_norm(x), cfg, cache["k"][i], cache["v"][i], position, wsc)
            x = x + a
            if cfg.moe is not None:
                y, aux_l = moe.moe_layer(block.moe, block.mlp_norm(x), cfg, wsc)
                moe_aux.append(aux_l)
            else:
                y = block.mlp(block.mlp_norm(x), wsc)
            x = x + y
            k_news.append(k_new)
            v_news.append(v_new)
        # one slice write for all layers (O(L) bytes, not O(L·S))
        cache["k"][:, :, position:position + 1] = torch.stack(k_news).to(cache["k"].dtype)
        cache["v"][:, :, position:position + 1] = torch.stack(v_news).to(cache["v"].dtype)
        if cfg.moe is not None:
            aux["expert_counts"] = _sum_moe_aux(moe_aux)["expert_counts"]
    x = model.final_norm(x)
    logits = mm(x, model.head()).to(torch.float32)
    return wsc(logits, "bsv"), cache, aux
