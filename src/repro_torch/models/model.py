"""Model assembly for the dense GQA family: qwen2.5-14b, yi-34b, qwen1.5-110b.

The counterpart of ``repro.models.model``'s dense branch (GQA, QKV bias,
optional sliding window and ``q_head_pad``): one parameter construction
(:class:`DenseLM`, an ``nn.Module`` in the JAX layout), one forward over the
layer list, one cached :func:`decode_step`. Every other family (MLA, MoE,
ssm, hybrid, audio, vlm) raises ``NotImplementedError``: its modules are
ROADMAP.md §1 item 3(b).

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
from repro_torch.models.layers import MLP, empty_param, make_norm, mm, normal_
from repro_torch.models.rope import apply_rope


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def check_family(cfg) -> None:
    """Raise unless ``cfg`` is of the dense GQA family the port runs."""
    if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
        kind = "mla" if cfg.mla is not None else "moe" if cfg.moe is not None else cfg.family
        raise NotImplementedError(
            f"{cfg.name}: the {kind} family is not ported yet (ROADMAP.md §1 "
            f"item 3(b)); the port runs the dense GQA family")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder layer: norm → attention → residual, norm → MLP → residual."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = _dt(cfg)
        self.attn_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                   dtype=dt, device=device)
        self.attn = attn.Attention(cfg, dtype=dt, device=device)
        self.mlp_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                  dtype=dt, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.attn_norm.init_weights()
        self.attn.init_weights(generator)
        self.mlp_norm.init_weights()
        self.mlp.init_weights(generator)


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
    ``include_embed``), counted on the ``meta`` device. The dense family
    has no inactive parameters, so ``active_only`` counts the same."""
    return sum(p.numel() for name, p in param_shapes(cfg).items()
               if include_embed or name not in ("embed", "lm_head"))


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
    a, kv = _self_attention(block, block.attn_norm(x), cfg, positions, wsc,
                            schedule=schedule)
    x = x + a
    return x + block.mlp(block.mlp_norm(x), wsc), kv


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of the plain weight products
    (``aten.mm``: ``x @ w`` of an activation and a matrix), recompute the
    rest. The counterpart of ``dots_with_no_batch_dims_saveable``: the
    attention's batched products (``bmm``) are recomputed."""
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


def _remat_layers(fns: list, x: torch.Tensor, remat: str) -> torch.Tensor:
    """Run the layer functions ``fns`` over ``x`` under the remat policy.

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
    if remat == "none":
        for f in fns:
            x = f(x)
        return x
    if remat in ("full", "dots"):
        for f in fns:
            x = _checkpointed(f, remat)(x)
        return x
    if remat.startswith("nested"):
        want = int(remat.split(":")[1]) if ":" in remat else 8
        n = len(fns)
        g = max(d for d in range(1, min(want, n) + 1) if n % d == 0)

        def group_fn(group):
            def run(h):
                for f in group:
                    h = _checkpointed(f)(h)
                return h
            return run

        for i in range(0, n, g):
            x = _checkpointed(group_fn(fns[i:i + g]))(x)
        return x
    raise ValueError(f"remat {remat!r} not in ('none', 'full', 'dots', 'nested:<G>')")


def forward(model: DenseLM, batch: dict, cfg, wsc=None, schedule="masked",
            collect=False):
    """batch: {'tokens' (B,S) [, 'positions' (B,S)]}.

    Returns (logits_f32 (B,S,V), aux dict). With ``collect=True`` (the
    serving *prefill* path) aux["cache"] holds the per-layer KV cache in
    the layout of :func:`cache_shapes` (max_len = S). Otherwise, with
    gradients on (training), the layers run under ``cfg.remat``
    (:func:`_remat_layers`).
    """
    check_family(cfg)
    wsc = wsc or (lambda a, _: a)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(tokens)
    x = wsc(F.embedding(tokens, model.embed).to(_cdt(cfg)), "bsd")
    ks, vs = [], []
    if collect:
        for block in model.layers:
            x, (k, v) = _dense_block(block, x, cfg, positions, wsc, schedule)
            x = wsc(x, "bsd")
            ks.append(k.to(_cdt(cfg)))
            vs.append(v.to(_cdt(cfg)))
    else:
        def layer(block):
            return lambda h: wsc(_dense_block(block, h, cfg, positions, wsc, schedule)[0],
                                 "bsd")
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        x = _remat_layers([layer(b) for b in model.layers], x, remat)
    x = model.final_norm(x)
    logits = wsc(mm(x, model.head()).to(torch.float32), "bsv")
    aux: dict = {}
    if collect:
        aux["cache"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, aux


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
    logits, aux = forward(model, batch, cfg, wsc, schedule=schedule)
    loss = cross_entropy(logits, batch["labels"], cfg.z_loss)
    aux["ce_loss"] = loss
    return loss, aux


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg, batch_size: int, max_len: int) -> dict:
    """The decode cache as ``meta`` tensors: k, v (L, B, S, KV, hd)."""
    check_family(cfg)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    return {name: torch.empty(shape, dtype=_cdt(cfg), device="meta")
            for name in ("k", "v")}


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
    positions [0, position]. The cache is read-only inside the layer loop;
    after it, one slice write per tensor puts every layer's new k/v at
    ``position``. That write is in place: the returned cache is ``cache``.
    """
    check_family(cfg)
    wsc = wsc or (lambda a, _: a)
    x = F.embedding(tokens, model.embed).to(_cdt(cfg))
    k_news, v_news = [], []
    for i, block in enumerate(model.layers):
        a, k_new, v_new = _decode_self_attention_ro(
            block, block.attn_norm(x), cfg, cache["k"][i], cache["v"][i], position, wsc)
        x = x + a
        x = x + block.mlp(block.mlp_norm(x), wsc)
        k_news.append(k_new)
        v_news.append(v_new)
    # one slice write for all layers (O(L) bytes, not O(L·S))
    cache["k"][:, :, position:position + 1] = torch.stack(k_news).to(cache["k"].dtype)
    cache["v"][:, :, position:position + 1] = torch.stack(v_news).to(cache["v"].dtype)
    x = model.final_norm(x)
    logits = mm(x, model.head()).to(torch.float32)
    return wsc(logits, "bsv"), cache, {}
