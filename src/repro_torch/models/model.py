"""Model assembly for every family: dense GQA (qwen2.5-14b, yi-34b,
qwen1.5-110b), MLA (minicpm3-4b), MoE (qwen3-moe-30b-a3b, mixtral-8x7b),
SSM (mamba2-130m), hybrid (zamba2-7b), audio (whisper-tiny) and vlm
(qwen2-vl-72b).

The counterpart of ``repro.models.model``: one parameter construction
(:class:`LM`, an ``nn.Module`` in the JAX layout), one forward over the
layer list, one cached :func:`decode_step`. A dense layer (:class:`Block`)
is an MLA or a GQA attention with QKV bias, optional sliding window and
``q_head_pad``, then an MoE FFN or an MLP; an SSM layer
(:class:`MambaBlock`) is a norm and a Mamba-2 mixer (``models/mamba2.py``);
the hybrid family runs one ``shared_attn`` block (a dense :class:`Block`,
its weights shared) after every ``hybrid_attn_every``-th Mamba layer. The
audio family is an encoder-decoder: an :class:`Encoder` of non-causal
blocks over stub frame embeddings, and decoder blocks that add a cross
attention over its output (``cross_norm``, ``cross_attn``); neither
stack uses RoPE, both add sinusoidal positions. The vlm family is the
dense GQA branch with M-RoPE and stub patch embeddings written over the
first prompt rows.

Weights come from a seeded ``torch.Generator`` with the JAX package's
scales (normal × fan_in^-½, ``embed`` 1.0, ``wo`` (hq·hd)^-½/√(2L), zero
biases, ones norms, U[0, 1) for an SSM's ``dt_bias``); the bits differ from
JAX's threefry draws, so a test that compares the two packages carries
JAX's weights over with ``models/convert.py``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, mla, moe
from repro_torch.models.layers import (MLP, empty_param, make_norm, mm, normal_,
                                       sinusoidal_positions, whole_on)
from repro_torch.models.rope import apply_mrope, apply_rope


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_family(cfg) -> None:
    """Raise unless ``cfg.family`` is one the model runs: dense (GQA or MLA
    attention), moe, ssm, hybrid, audio or vlm."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no model for the family {cfg.family!r}; the families are "
            f"{', '.join(FAMILIES)}")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One transformer layer: norm → attention → residual, [norm → cross
    attention → residual,] norm → FFN → residual.

    ``attn`` is an :class:`~repro_torch.models.mla.MLA` when ``cfg.mla``
    is set, else a GQA :class:`~repro_torch.models.attention.Attention`;
    the FFN is ``moe`` (:class:`~repro_torch.models.moe.MoE`) when
    ``cfg.moe`` is set, else ``mlp``. With ``cross`` (a whisper decoder
    layer) it also holds ``cross_norm`` and ``cross_attn``, an attention
    whose k/v are projected from the encoder's output."""

    def __init__(self, cfg, *, device=None, cross: bool = False):
        super().__init__()
        dt = _dt(cfg)
        self.attn_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                   dtype=dt, device=device)
        self.attn = (mla.MLA(cfg, dtype=dt, device=device) if cfg.mla is not None
                     else attn.Attention(cfg, dtype=dt, device=device))
        if cross:
            self.cross_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                        dtype=dt, device=device)
            self.cross_attn = attn.Attention(cfg, dtype=dt, device=device)
        self.mlp_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                  dtype=dt, device=device)
        if cfg.moe is not None:
            self.moe = moe.MoE(cfg, dtype=dt, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype=dt, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.attn_norm.init_weights()
        self.attn.init_weights(generator)
        if hasattr(self, "cross_attn"):
            self.cross_norm.init_weights()
            self.cross_attn.init_weights(generator)
        self.mlp_norm.init_weights()
        (self.moe if hasattr(self, "moe") else self.mlp).init_weights(generator)


class Encoder(nn.Module):
    """The audio family's encoder: ``layers`` (``cfg.enc_dec.n_enc_layers``
    blocks, run non-causal) and ``final_norm``. Its attention's
    ``wo`` takes the decoder's depth in its init scale, as the JAX
    package's ``attn_params`` does."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.enc_dec.n_enc_layers))
        self.final_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                    dtype=_dt(cfg), device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        for block in self.layers:
            block.init_weights(generator)
        self.final_norm.init_weights()


class MambaBlock(nn.Module):
    """One SSM layer: ``ssm_norm`` → the Mamba-2 ``mixer`` → residual."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = _dt(cfg)
        self.ssm_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                  dtype=dt, device=device)
        self.mixer = mamba2.Mamba2(cfg, dtype=dt, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.ssm_norm.init_weights()
        self.mixer.init_weights(generator)


class LM(nn.Module):
    """``embed`` (V, D), for the audio family an ``encoder``
    (:class:`Encoder`, else None), ``layers`` (one :class:`Block` a layer,
    with a cross attention for the audio family, or one
    :class:`MambaBlock` for the ssm and hybrid families), for the hybrid
    family one ``shared_attn`` :class:`Block` (else None), ``final_norm``
    and ``lm_head`` (D, V), or the transposed embedding when
    ``cfg.tie_embeddings``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        dt = _dt(cfg)
        self.embed = empty_param((cfg.vocab, cfg.d_model), dt, device)
        audio = cfg.family == "audio"
        self.encoder = Encoder(cfg, device=device) if audio else None
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(MambaBlock(cfg, device=device)
                                        for _ in range(cfg.n_layers))
        else:
            self.layers = nn.ModuleList(Block(cfg, device=device, cross=audio)
                                        for _ in range(cfg.n_layers))
        self.shared_attn = Block(cfg, device=device) if cfg.family == "hybrid" else None
        self.final_norm = make_norm(cfg.d_model, cfg.norm_type, cfg.norm_eps,
                                    dtype=dt, device=device)
        self.lm_head = (None if cfg.tie_embeddings
                        else empty_param((cfg.d_model, cfg.vocab), dt, device))

    def init_weights(self, generator: torch.Generator, each=None) -> None:
        """Fill every parameter from ``generator``, one unit (a top-level
        parameter or submodule) after another. ``each(name, fill)``, if
        given, is called for every unit in draw order and must call
        ``fill()`` once (``train/steps.py:init_model`` allocates the unit
        before and distributes it after)."""
        each = each or (lambda name, fill: fill())
        each("embed", lambda: normal_(self.embed, generator, scale=1.0))
        if self.encoder is not None:
            each("encoder", lambda: self.encoder.init_weights(generator))
        for i, block in enumerate(self.layers):
            each(f"layers.{i}", lambda: block.init_weights(generator))  # noqa: B023
        if self.shared_attn is not None:
            each("shared_attn", lambda: self.shared_attn.init_weights(generator))
        each("final_norm", lambda: self.final_norm.init_weights())
        if self.lm_head is not None:
            each("lm_head", lambda: normal_(self.lm_head, generator))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head


def build_params(cfg, device=None) -> LM:
    """The model with its parameters allocated on ``device`` but not filled
    (``device="meta"``: shapes and dtypes only)."""
    return LM(cfg, device=device)


def init_params(cfg, generator: torch.Generator, device=None) -> LM:
    """A model on ``device`` (default: the generator's) with fresh weights."""
    model = build_params(cfg, generator.device if device is None else device)
    model.init_weights(generator)
    return model


def param_shapes(cfg) -> dict:
    """Every parameter as a ``meta`` tensor, keyed as the ``state_dict``."""
    return dict(build_params(cfg, "meta").state_dict())


# the JAX package's logical axes of each leaf (``build_params(cfg, "axes")``),
# without the "layers," that its ``stacked`` puts before a stacked leaf's; an
# MoE block's w_gate/w_up/w_down (E, ·, ·) take the expert axes
_AXES = {
    "wq": "embed,attn_out", "wk": "embed,kv_out", "wv": "embed,kv_out",
    "wo": "attn_out,embed", "bq": "attn_out", "bk": "kv_out", "bv": "kv_out",
    "w_gate": "embed,ff", "w_up": "embed,ff", "w_down": "ff,embed",
    "b_up": "ff", "b_down": "norm", "router": "embed,router",
    "wdq": "embed,lora", "wdkv": "embed,lora", "wuq": "lora,attn_out",
    "wuk": "lora,attn_out", "wuv": "lora,attn_out",
    "in_proj": "embed,ssm_in", "out_proj": "ssm_inner,embed",
    "conv_w": "convk,ssm_conv", "conv_b": "ssm_conv",
    "A_log": "ssm_heads", "D": "ssm_heads", "dt_bias": "ssm_heads",
    "lm_head": "embed,vocab",
}
_EXPERT_AXES = {"w_gate": "experts,embed,expert_ff", "w_up": "experts,embed,expert_ff",
                "w_down": "experts,expert_ff,embed"}


def _leaf_axes(cfg, leaf: str, ndim: int) -> str:
    """The logical axes of the JAX leaf ``leaf`` (one layer's, ``ndim`` dims)."""
    if leaf == "embed":
        return "vocab_rows,embed_tp" if cfg.embed_rows_local else "vocab,embed"
    if ndim == 3 and leaf in _EXPERT_AXES:
        return _EXPERT_AXES[leaf]
    if leaf.startswith("cross_") and not leaf.startswith("cross_norm_"):
        leaf = leaf[len("cross_"):]
    if leaf in _AXES:
        return _AXES[leaf]
    if leaf.endswith(("_scale", "_bias")):            # every norm
        return "norm"
    raise KeyError(f"{cfg.name}: no logical axes for the leaf {leaf!r}")


def state_dict_axes(cfg) -> dict:
    """The logical axes of every parameter, keyed as the ``state_dict``: a
    layer's tensor takes its stacked leaf's axes without the leading
    ``layers`` (``PARAM_RULES["layers"]`` is ``()``, so that dim is
    replicated whatever the mesh and dropping it changes no spec)."""
    from repro_torch.models.convert import jax_path
    out = {}
    for name, t in param_shapes(cfg).items():
        _, leaf, _ = jax_path(cfg, name)
        out[name] = _leaf_axes(cfg, leaf, t.dim())
    return out


def param_axes(cfg) -> dict:
    """The JAX package's ``param_axes(cfg)``: the comma-joined logical axis
    names of every leaf of its parameter tree, keyed and stacked as its
    ``build_params`` lays the tree out (``layers``/``enc_layers``/
    ``dec_layers`` stacks, whose leaves begin with ``layers,``; the hybrid
    family's ``shared_attn`` unstacked)."""
    from repro_torch.models.convert import jax_path
    tree: dict = {}
    for name, axes in state_dict_axes(cfg).items():
        group, leaf, layer = jax_path(cfg, name)
        if group is None:
            tree[leaf] = axes
        else:
            tree.setdefault(group, {})[leaf] = axes if layer is None else "layers," + axes
    return tree


def param_count(cfg, active_only: bool = False, include_embed: bool = False) -> int:
    """Parameters of the model (``embed``/``lm_head`` only if
    ``include_embed``), counted on the ``meta`` device. ``active_only``
    scales the expert stacks by top_k/E, by the JAX package's rule on its
    stacked layout: a leaf of 2 dims or more whose third dim from the end
    is n_experts. The hybrid family's shared block counts once, the audio
    family's encoder with the decoder."""
    from repro_torch.models.convert import stack_params
    tree = stack_params(cfg, param_shapes(cfg))
    leaves = [(n, t) for n, t in tree.items() if not isinstance(t, dict)]
    leaves += [leaf for sub in tree.values() if isinstance(sub, dict) for leaf in sub.items()]
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

def _positions(tokens: torch.Tensor, cfg) -> torch.Tensor:
    """0..S-1 a row: (B, S), or (3, B, S) (the M-RoPE streams) for vlm."""
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return pos[None].expand(3, b, s) if cfg.vlm is not None else pos


def _reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending (partial) sums reduced; ``t`` itself
    otherwise. A vocab-parallel lookup (an embedding, a gather of the label
    logits) leaves a masked partial sum that DTensor can reduce only in
    the lookup's own shape, so it is reduced where it is made."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def _embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``. A DTensor table is first gathered on
    the mesh dims that shard its embedding dim (FSDP's gather before use):
    DTensor's vocab-parallel lookup builds its mask of the wrong shape when
    the batch and the embedding dim are sharded on the same mesh dim."""
    return _reduce_partial(F.embedding(tokens, whole_on(table, 1)))


def _rope(x, positions, cfg):
    """RoPE of q or k (B, S, H, hd): M-RoPE over (3, B, S) positions for
    vlm, else over (B, S)."""
    if cfg.vlm is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.vlm.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _self_attention(block: Block, h, cfg, positions, wsc, *, schedule="masked",
                    causal=True):
    """-> (out, (k, v)). The audio family (``cfg.enc_dec``) takes no RoPE:
    its positions are the sinusoidal table added to its inputs."""
    q, k, v = attn.project_qkv(block.attn, h, cfg)
    if cfg.enc_dec is None:
        q = _rope(q, positions, cfg)
        k = _rope(k, positions, cfg)
    q, k, v = wsc(q, "bshd"), wsc(k, "bskvh"), wsc(v, "bskvh")
    blockwise = functools.partial(attn.blockwise_attention, causal=causal,
                                  window=cfg.swa_window, schedule=schedule,
                                  remat_tiles=cfg.attn_remat_tiles)
    if isinstance(q, DTensor):
        out = attn.local_heads(blockwise, q, k, v)
    else:
        out = blockwise(q, k, v)
    out = attn.mask_pad_heads(out, cfg)
    return mm(attn.merge_heads(wsc(out, "bshd")), block.attn.wo), (k, v)


def _cross_attention(block: Block, h, enc_out, cfg, wsc):
    """Non-causal attention of the decoder's ``h`` against k/v projected
    from ``enc_out`` (no head mask, as the JAX package's) -> (out, (ck,
    cv)): ``ck``/``cv`` (B, n_frames, KV, hd) are the prefill cache's. On a
    mesh it runs on each rank's heads (``attention.local_heads``)."""
    q, ck, cv = attn.project_qkv(block.cross_attn, h, cfg, x_kv=enc_out)
    q, ck, cv = wsc(q, "bshd"), wsc(ck, "bskvh"), wsc(cv, "bskvh")
    cross = functools.partial(attn.blockwise_attention, causal=False)
    out = attn.local_heads(cross, q, ck, cv) if isinstance(q, DTensor) else cross(q, ck, cv)
    return mm(attn.merge_heads(wsc(out, "bshd")), block.cross_attn.wo), (ck, cv)


def _seq_sharded(x) -> bool:
    """Whether ``x`` is a (B, S, D) DTensor with its sequence sharded: the
    residual stream under ``seq_sharded_residual``."""
    return isinstance(x, DTensor) and x.dim() == 3 and any(
        isinstance(p, Shard) and p.dim == 1 for p in x.placements)


def _enter(h):
    """A section's input ``h`` (a norm of the residual stream) with its
    sequence made whole, sequence parallelism's all-gather: a section's
    products flatten (B, S), which torch 2.11's DTensor refuses when S is
    sharded. :func:`_join` scatters the section's output back."""
    return whole_on(h, 1) if _seq_sharded(h) else h


def _join(x, y, wsc):
    """``x + y``: a section's output ``y`` joins the residual stream ``x``.
    When the stream's sequence is sharded (``seq_sharded_residual``), ``y``
    is first put in the stream's layout (``wsc(y, "bsd")``): the reduction
    DTensor's add would choose, but its backward hands the section's
    gradient back in ``y``'s own placements, which torch 2.11's DTensor
    needs to flatten (B, S) in the backward of ``y``'s product."""
    if _seq_sharded(x):
        y = wsc(y, "bsd")
    return x + y


def _dense_block(block: Block, x, cfg, positions, wsc, schedule="masked", *,
                 causal=True, enc_out=None):
    """-> (x, aux, kv): ``aux`` the MoE's {'expert_counts', 'aux_loss'} (or
    empty), ``kv`` the layer's cache entries ({'k', 'v'} or {'c_kv',
    'k_rope'}; with ``enc_out``, a whisper decoder layer, also {'ck',
    'cv'}); each section enters through :func:`_enter` and its output
    joins the stream through :func:`_join`."""
    h = _enter(block.attn_norm(x))
    if cfg.mla is not None:
        a, (c_kv, k_rope) = mla.mla_prefill(block.attn, h, cfg, positions,
                                            schedule=schedule, wsc=wsc)
        kv = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        a, (k, v) = _self_attention(block, h, cfg, positions, wsc, schedule=schedule,
                                    causal=causal)
        kv = {"k": k, "v": v}
    x = _join(x, a, wsc)
    if enc_out is not None:
        c, (ck, cv) = _cross_attention(block, _enter(block.cross_norm(x)), enc_out, cfg,
                                       wsc)
        kv.update(ck=ck, cv=cv)
        x = _join(x, c, wsc)
    h = _enter(block.mlp_norm(x))
    if cfg.moe is not None:
        y, aux = moe.moe_layer(block.moe, h, cfg, wsc)
    else:
        y, aux = block.mlp(h, wsc), {}
    return _join(x, y, wsc), aux, kv


def _mamba_res_block(block: MambaBlock, x, cfg, wsc, collect=False):
    """-> (x, cache): ``cache`` the layer's decode state {'ssm_state' f32,
    'conv'} when ``collect``, else empty."""
    h = _enter(block.ssm_norm(x))
    if collect:
        y, (st, tail) = mamba2.mamba_block(block.mixer, h, cfg, wsc, return_state=True)
        return _join(x, y, wsc), {"ssm_state": st, "conv": tail}
    return _join(x, mamba2.mamba_block(block.mixer, h, cfg, wsc), wsc), {}


def _layer(model: "LM", i: int, x, cfg, positions, wsc, schedule="masked", collect=False,
           enc_out=None):
    """Layer ``i`` of any family -> (x, aux, cache): ``aux`` the MoE's
    {'expert_counts', 'aux_loss'} (or empty), ``cache`` the layer's cache
    entries ({'k', 'v'} and for a whisper decoder layer, given ``enc_out``,
    {'ck', 'cv'}; {'c_kv', 'k_rope'}; or {'ssm_state', 'conv'} and, after a
    hybrid layer that runs the shared block, {'shared_k', 'shared_v'}). A
    hybrid layer i runs the shared block after its Mamba block when (i + 1)
    % ``hybrid_attn_every`` == 0, so a checkpoint of the layer holds the
    shared block's application too."""
    block = model.layers[i]
    if isinstance(block, Block):
        return _dense_block(block, x, cfg, positions, wsc, schedule, enc_out=enc_out)
    x, cache = _mamba_res_block(block, x, cfg, wsc, collect)
    if model.shared_attn is not None and (i + 1) % cfg.hybrid_attn_every == 0:
        x, _, kv = _dense_block(model.shared_attn, x, cfg, positions, wsc, schedule)
        if collect:
            cache.update(shared_k=kv["k"], shared_v=kv["v"])
    return x, {}, cache


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


def _encode(model: LM, frames: torch.Tensor, cfg, wsc, remat: str) -> torch.Tensor:
    """The audio encoder over stub frame embeddings (B, n_frames, D): the
    sinusoidal table (f32, cast to the compute dtype) added, the layers
    non-causal under ``remat``, then its final norm."""
    n = cfg.enc_dec.n_frames
    if frames.dim() != 3 or frames.shape[1] != n:
        raise ValueError(f"{cfg.name}: frames of shape {tuple(frames.shape)}, want "
                         f"(B, {n}, {cfg.d_model})")
    frames = frames.to(_cdt(cfg))
    h = frames + sinusoidal_positions(n, cfg.d_model, frames.dtype, frames.device)[None]

    def layer(block):
        def run(v):
            v, _, _ = _dense_block(block, v, cfg, None, wsc, causal=False)
            return (wsc(v, "bsd"),)
        return run
    h, _ = _remat_layers([layer(b) for b in model.encoder.layers], h, remat)
    return _enter(model.encoder.final_norm(h))


def _write_vision(x: torch.Tensor, vision_embeds: torch.Tensor) -> torch.Tensor:
    """Rows 0..n_patches-1 of the embedded tokens x (B, S, D) replaced by
    the stub patch embeddings (B, n_patches, D), cast to x's dtype."""
    n = vision_embeds.shape[1]
    if vision_embeds.shape[0] != x.shape[0] or n > x.shape[1]:
        raise ValueError(f"vision_embeds {tuple(vision_embeds.shape)} do not fit the "
                         f"embedded prompt {tuple(x.shape)}: a prompt holds at least "
                         f"n_patches positions")
    return torch.cat([vision_embeds.to(x.dtype), x[:, n:]], dim=1)


def forward(model: LM, batch: dict, cfg, wsc=None, schedule="masked",
            collect=False):
    """batch: {'tokens' (B,S) [, 'positions' (B,S), or (3,B,S) for vlm]
    [, 'vision_embeds' (B,n_patches,D) for vlm] [, 'frames'
    (B,n_frames,D), which the audio family needs]}.

    Returns (logits_f32 (B,S,V), aux dict). With ``collect=True`` (the
    serving *prefill* path) aux["cache"] holds the per-layer cache in the
    layout of :func:`cache_shapes` (max_len = S): every entry in the
    compute dtype but an SSM's ``ssm_state``, which stays f32. Otherwise,
    with gradients on (training), the layers run under ``cfg.remat``
    (:func:`_remat_layers`; the audio family's encoder and decoder each);
    the hybrid and audio families map ``nested:G`` to a checkpoint a layer,
    as the JAX package's ``lax.scan(_remat(body))`` does. For the MoE
    family aux also holds ``expert_counts`` (E,) int32 and ``aux_loss``,
    each summed over the layers.
    """
    check_family(cfg)
    wsc = wsc or (lambda a, _: a)
    tokens = batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(tokens, cfg)
    x = wsc(_embed(tokens, model.embed).to(_cdt(cfg)), "bsd")
    if cfg.vlm is not None and "vision_embeds" in batch:
        x = _write_vision(x, batch["vision_embeds"])
    remat = cfg.remat if torch.is_grad_enabled() and not collect else "none"
    if cfg.family in ("hybrid", "audio") and remat.startswith("nested"):
        remat = "full"
    enc_out = None
    if cfg.family == "audio":
        enc_out = _encode(model, batch["frames"], cfg, wsc, remat)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    n = len(model.layers)
    moe_aux, caches = [], []
    if collect:
        for i in range(n):
            x, aux_l, cache_l = _layer(model, i, x, cfg, positions, wsc, schedule, True,
                                       enc_out)
            x = wsc(x, "bsd")
            moe_aux.append(aux_l)
            caches.append(cache_l)
    else:
        def layer(i):
            def run(h):
                h, aux_l, _ = _layer(model, i, h, cfg, positions, wsc, schedule,
                                     enc_out=enc_out)
                return (wsc(h, "bsd"), *aux_l.values())
            return run
        x, extras = _remat_layers([layer(i) for i in range(n)], x, remat)
        moe_aux = [dict(zip(("expert_counts", "aux_loss"), e)) for e in extras]
    x = _enter(model.final_norm(x))
    logits = wsc(mm(x, model.head()).to(torch.float32), "bsv")
    aux: dict = {}
    if cfg.moe is not None:
        aux.update(_sum_moe_aux(moe_aux))
    if collect:
        names = dict.fromkeys(name for c in caches for name in c)
        aux["cache"] = {name: torch.stack([c[name] for c in caches if name in c])
                        for name in names}
        aux["cache"] = {name: t if name == "ssm_state" else t.to(_cdt(cfg))
                        for name, t in aux["cache"].items()}
    return logits, aux


def _sum_moe_aux(per_layer: list) -> dict:
    """The layers' MoE aux summed: expert counts (E,) int32, the aux loss."""
    return {"expert_counts": torch.stack([a["expert_counts"] for a in per_layer])
            .sum(0, dtype=torch.int32),
            "aux_loss": torch.stack([a["aux_loss"] for a in per_layer]).sum()}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean cross entropy (+ ``z_loss`` · mean lse²); on a mesh
    vocab-parallel (:func:`_vocab_parallel`)."""
    if isinstance(logits, DTensor):
        lse, label_logit = _vocab_parallel(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (lse - label_logit).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def _vocab_parallel(logits: DTensor, labels: torch.Tensor):
    """(lse, label logit) of (B, S, V) logits, each rank on its own rows and
    vocab slice. DTensor's own logsumexp gathers the vocab on every rank,
    and its gather's backward makes a zero gradient of the global logits'
    shape there (210.9 GB a device at mamba2-130m × train_4k, the dry run's
    count). The label logit is each rank's masked local gather, summed over
    the vocab's shards (exact: one term is not zero); the lse is the
    shards' max plus the log of their summed exponentials (the vocab whole
    on a rank: ``torch.logsumexp``, as one process computes it)."""
    mesh, pl = logits.device_mesh, logits.placements
    vocab = [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 2]
    rows = [Replicate() if i in vocab else p for i, p in enumerate(pl)]
    pieces = math.prod(mesh.size(i) for i in vocab)
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, pl)
    local = logits.to_local()
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    at = labels.redistribute(mesh, rows).to_local().long()[..., None] - offset[2]
    inside = (at >= 0) & (at < local.shape[2])
    got = torch.where(inside, local.gather(-1, at.clamp(0, local.shape[2] - 1)), 0)
    shape = (*labels.shape, pieces)
    label_logit = _reduce_partial(DTensor.from_local(
        got, mesh, [Shard(2) if i in vocab else p for i, p in enumerate(rows)],
        run_check=False, shape=shape, stride=torch.empty(shape, device="meta").stride()
    ).sum(-1))
    if pieces == 1:
        return torch.logsumexp(logits, dim=-1), label_logit
    top = _reduce_partial(logits.detach().amax(-1))
    lse = top + _reduce_partial((logits - top[..., None]).exp().sum(-1)).log()
    return lse, label_logit


def loss_fn(model: LM, batch: dict, cfg, wsc=None, schedule="masked"):
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
    MLA c_kv (L, B, S, kv_lora) and k_rope (L, B, S, rope); for the ssm
    and hybrid families ssm_state (L, B, G, Hg, N, P) f32 and conv (L, B,
    d_conv - 1, conv_dim), and for hybrid shared_k, shared_v (n_apps, B,
    S, KV, hd); for audio also ck, cv (L, B, n_frames, KV, hd), the cross
    attention's k/v of the encoder's output. All but ssm_state in the
    compute dtype."""
    check_family(cfg)
    cdt = _cdt(cfg)
    lead = (cfg.n_layers, batch_size, max_len)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        _, h, conv_dim, _ = mamba2.ssm_dims(cfg)
        shapes = {"ssm_state": ((cfg.n_layers, batch_size, s.n_groups, h // s.n_groups,
                                 s.d_state, s.headdim), torch.float32),
                  "conv": ((cfg.n_layers, batch_size, s.d_conv - 1, conv_dim), cdt)}
        if cfg.family == "hybrid":
            n_apps = cfg.n_layers // cfg.hybrid_attn_every
            kv = (n_apps, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
            shapes.update(shared_k=(kv, cdt), shared_v=(kv, cdt))
    elif cfg.mla is not None:
        shapes = {"c_kv": (lead + (cfg.mla.kv_lora_rank,), cdt),
                  "k_rope": (lead + (cfg.mla.qk_rope_head_dim,), cdt)}
    else:
        shapes = {name: (lead + (cfg.n_kv_heads, cfg.hd), cdt) for name in ("k", "v")}
        if cfg.family == "audio":
            cross = (cfg.n_layers, batch_size, cfg.enc_dec.n_frames, cfg.n_kv_heads, cfg.hd)
            shapes.update(ck=(cross, cdt), cv=(cross, cdt))
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in shapes.items()}


def init_cache(cfg, batch_size: int, max_len: int, device=None) -> dict:
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in cache_shapes(cfg, batch_size, max_len).items()}


def _decode_qkv(block: Block, h, cfg, position: int):
    """The new token's q, k, v (B, 1, ·, hd), RoPE'd at ``position`` (the
    position broadcast to (3, B, 1) for vlm; none for audio)."""
    b = h.shape[0]
    q, k_new, v_new = attn.project_qkv(block.attn, h, cfg)
    if cfg.enc_dec is None:
        pos = torch.full((b, 1), position, dtype=torch.int32, device=h.device)
        if cfg.vlm is not None:
            pos = pos[None].expand(3, b, 1)
        q = _rope(q, pos, cfg)
        k_new = _rope(k_new, pos, cfg)
    return q, k_new, v_new


def _decode_self_attention_ro(block: Block, h, cfg, k_cache, v_cache, position, wsc):
    """Read-only-cache decode attention: returns (out, k_new, v_new)."""
    q, k_new, v_new = _decode_qkv(block, h, cfg, position)
    # on a mesh: the new token's heads whole (bskvh's spec), so the grouped
    # products below flatten no sharded head dim
    q, k_new, v_new = wsc(q, "bskvh"), wsc(k_new, "bskvh"), wsc(v_new, "bskvh")
    out = attn.decode_attention_plus_one(
        q, wsc(k_cache, "bskh"), wsc(v_cache, "bskh"), k_new, v_new, position,
        window=cfg.swa_window)
    out = attn.mask_pad_heads(out, cfg)
    return mm(attn.merge_heads(out), block.attn.wo), k_new, v_new


def _decode_self_attention(block: Block, h, cfg, cache, i, position, wsc):
    """Decode attention that writes the cache first: the new k/v go into
    layer ``i`` of ``cache['k']``/``cache['v']`` (L, B, S, KV, hd) at
    ``position`` in place (:func:`_write_position`), then q attends over
    [0, position] (the JAX package's whisper decode)."""
    q, k_new, v_new = _decode_qkv(block, h, cfg, position)
    q, k_new, v_new = wsc(q, "bskvh"), wsc(k_new, "bskvh"), wsc(v_new, "bskvh")
    _write_position(cache["k"], position, k_new[None], slice(i, i + 1))
    _write_position(cache["v"], position, v_new[None], slice(i, i + 1))
    out = attn.decode_attention(q, wsc(cache["k"][i], "bskh"), wsc(cache["v"][i], "bskh"),
                                position + 1, window=cfg.swa_window)
    out = attn.mask_pad_heads(out, cfg)
    return mm(attn.merge_heads(out), block.attn.wo)


def _decode_cross_attention(block: Block, h, cfg, ck, cv, wsc):
    """The new token's cross attention over the prefill's ck/cv (B,
    n_frames, KV, hd), which it reads whole (on a mesh each rank reads its
    own frames: ``decode_attention`` takes the softmax in parts)."""
    cross = block.cross_attn
    q = mm(h, cross.wq)
    if cfg.qkv_bias:
        q = q + cross.bq.to(h.dtype)
    q = wsc(attn.split_heads(q, cfg.n_q_heads, cfg.hd), "bskvh")
    out = attn.decode_attention(q, wsc(ck, "bskh"), wsc(cv, "bskh"), ck.shape[1])
    return mm(attn.merge_heads(out), cross.wo)


def _write_position(cache: torch.Tensor, position: int, new: torch.Tensor,
                    layers: slice = slice(None)) -> None:
    """``cache[layers, :, position] = new`` in place: ``new`` (L, B, 1, ...)
    into the cache (L, B, S, ...), or into its layers ``layers``. A DTensor
    cache whose sequence dim is sharded (``train/steps.py:cache_shardings``)
    is written through its local shard, on the ranks that hold
    ``position``: the new rows are laid out as the cache's but whole on the
    sequence dim, and no rank gathers the cache."""
    new = new.to(cache.dtype)
    if not isinstance(cache, DTensor):
        cache[layers, :, position:position + 1] = new
        return
    mesh = cache.device_mesh
    rows = new.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                                   for p in cache.placements]).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          cache.placements)
    at = position - offset[2]
    if 0 <= at < shape[2]:
        cache.to_local()[layers, :, at:at + 1] = rows


def decode_step(model: LM, cache: dict, tokens: torch.Tensor, position: int,
                cfg, wsc=None):
    """One decode step. tokens (B,1) -> (logits (B,1,V) f32, cache, aux).

    ``position`` is the index the new token occupies; attention spans
    positions [0, position]. The cache is written in place: the returned
    cache is ``cache``. GQA: the cache is read-only inside the layer loop;
    after it, one slice write per tensor puts every layer's new k/v at
    ``position``. MLA: each layer writes its latent line at ``position``,
    then attends over [0, position] in the absorbed form; its FFN is the
    dense MLP, as the JAX package's MLA branch runs it. SSM: each layer
    writes its state and conv window in place. Hybrid: after every
    ``hybrid_attn_every``-th layer the shared block attends over its
    application's cache, read-only in the loop; after it, one slice write
    puts the n_apps new k/v rows at ``position``. Audio: the sinusoidal row
    of ``position`` is added to the embedding; each layer writes its k/v at
    ``position`` and then attends over [0, position], and its cross
    attention reads the prefill's ck/cv, which come back unchanged (a
    whisper decode starts from a prefill cache: ``init_cache``'s zero
    ck/cv are not the encoder's). vlm: the dense GQA path with M-RoPE. For
    the MoE family aux holds ``expert_counts`` (E,) int32, summed over the
    layers.
    """
    check_family(cfg)
    wsc = wsc or (lambda a, _: a)
    x = _embed(tokens, model.embed).to(_cdt(cfg))
    aux: dict = {}
    if cfg.family == "audio":
        dpos = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.dtype, x.device)
        x = x + dpos[position:position + 1][None]
        for i, block in enumerate(model.layers):
            x = x + _decode_self_attention(block, block.attn_norm(x), cfg, cache, i,
                                           position, wsc)
            x = x + _decode_cross_attention(block, block.cross_norm(x), cfg,
                                            cache["ck"][i], cache["cv"][i], wsc)
            x = x + block.mlp(block.mlp_norm(x), wsc)
    elif cfg.family in ("ssm", "hybrid"):
        shared = model.shared_attn
        k_news, v_news = [], []
        for i, block in enumerate(model.layers):
            y, _, _ = mamba2.mamba_decode_step(block.mixer, block.ssm_norm(x), cfg,
                                               cache["ssm_state"][i], cache["conv"][i], wsc)
            x = x + y
            if shared is not None and (i + 1) % cfg.hybrid_attn_every == 0:
                app = (i + 1) // cfg.hybrid_attn_every - 1
                a, k_new, v_new = _decode_self_attention_ro(
                    shared, shared.attn_norm(x), cfg, cache["shared_k"][app],
                    cache["shared_v"][app], position, wsc)
                x = x + a
                x = x + shared.mlp(shared.mlp_norm(x), wsc)
                k_news.append(k_new)
                v_news.append(v_new)
        if k_news:      # one slice write for every application
            _write_position(cache["shared_k"], position, torch.stack(k_news))
            _write_position(cache["shared_v"], position, torch.stack(v_news))
    elif cfg.mla is not None:
        ck_all, kr_all = cache["c_kv"], cache["k_rope"]
        for i, block in enumerate(model.layers):
            hn = block.attn_norm(x)
            ckv_new, krope_new = mla.mla_new_cache_entry(block.attn, hn, cfg, position,
                                                         wsc)
            _write_position(ck_all, position, ckv_new[None], slice(i, i + 1))
            _write_position(kr_all, position, krope_new[None], slice(i, i + 1))
            x = x + mla.mla_decode(block.attn, hn, cfg,
                                   {"c_kv": ck_all[i], "k_rope": kr_all[i]}, position, wsc)
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
        _write_position(cache["k"], position, torch.stack(k_news))
        _write_position(cache["v"], position, torch.stack(v_news))
        if cfg.moe is not None:
            aux["expert_counts"] = _sum_moe_aux(moe_aux)["expert_counts"]
    x = model.final_norm(x)
    logits = mm(x, model.head()).to(torch.float32)
    return wsc(logits, "bsv"), cache, aux
