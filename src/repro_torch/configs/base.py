"""Architecture / run configuration schema.

A copy of ``repro.configs.base``: the same dataclasses with the same
fields and defaults, so that one config reads the same in both packages.
One ``ArchConfig`` describes any of the 10 assigned architectures; family-
specific sub-configs (MoE / SSM / MLA / enc-dec / VLM) are optional blocks.
``scaled()`` derives the reduced smoke-test variants. ``SketchConfig.kernel``
takes the JAX names too (``'pallas'``, ``'jnp'``): ``train/sketch.py`` maps
them to the port's (``'cuda'``, ``'torch'``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_norm_topk: bool = False    # qwen3: renormalize top-k probs
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 256          # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 4
    n_frames: int = 1500       # whisper: 30 s of audio after the conv stub
    frame_dim: Optional[int] = None   # defaults to d_model (precomputed embeds)


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256                 # stubbed patch embeddings per image
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w, sums to hd/2


@dataclass(frozen=True)
class SketchConfig:
    """Space Saving integration — the paper's technique as a framework feature.

    All fields feed repro_torch.engine.EngineConfig: the SketchEngine owns
    buffering, kernel dispatch and reductions (DESIGN.md §6).
    """
    enabled: bool = True
    k_counters: int = 2048          # counters for the token sketch
    expert_counters: int = 128      # counters for the MoE expert sketch
    chunk: int = 2048               # stream chunk per buffered update (C)
    buffer_depth: int = 8           # chunks buffered per deferred merge (T)
    flush_mode: str = "deferred"    # 'deferred' | 'replay' (engine flush)
    kernel: str = "auto"            # 'auto' | 'pallas' | 'jnp' | 'sorted' (or the
                                    # port's 'cuda' | 'torch' | 'fused')
    merge_every: int = 32           # steps between global butterfly merges
    reduction: str = "hierarchical"  # 'local' | 'butterfly' | 'allgather'
                                     # | 'hierarchical' (registry key)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | ssm | hybrid | audio | vlm | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"               # silu (SwiGLU) | gelu (plain MLP)
    norm_eps: float = 1e-6
    swa_window: Optional[int] = None      # mixtral sliding-window attention
    hybrid_attn_every: Optional[int] = None  # zamba2: shared attn block period
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    sketch: SketchConfig = field(default_factory=SketchConfig)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"             # none | full | dots | nested:<G>
    attn_remat_tiles: bool = False  # checkpoint flash tiles (§Perf)
    embed_rows_local: bool = False  # embed table (None,'model') — local gather
    z_loss: float = 0.0

    q_head_pad: int = 0   # extra zero-init q heads PER KV GROUP (§Perf:
                          # makes head count divisible by the model axis
                          # without changing the function — zero wo rows ⇒
                          # zero grads ⇒ pads stay zero forever)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_q_heads(self) -> int:
        """Padded head count used for q/wo parameter layout + attention."""
        g = self.n_heads // self.n_kv_heads
        return self.n_kv_heads * (g + self.q_head_pad)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §4)."""
        return (self.family in ("ssm", "hybrid")
                or self.swa_window is not None)

    def n_params(self) -> int:
        """Total parameter count (exact, mirrors init_params)."""
        from repro_torch.models.model import param_count
        return param_count(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import param_count
        return param_count(self, active_only=True)


def scaled(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.hybrid_attn_every is None else cfg.hybrid_attn_every + 1),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
    )
    if cfg.moe is not None:
        small["moe"] = replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 8),
                               top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    if cfg.ssm is not None:
        small["ssm"] = replace(cfg.ssm, d_state=16, headdim=32, chunk=16)
    if cfg.mla is not None:
        small["mla"] = replace(cfg.mla, q_lora_rank=64, kv_lora_rank=32,
                               qk_nope_head_dim=16, qk_rope_head_dim=16,
                               v_head_dim=32)
        small["head_dim"] = None
    if cfg.enc_dec is not None:
        small["enc_dec"] = replace(cfg.enc_dec, n_enc_layers=2, n_frames=32)
    if cfg.vlm is not None:
        small["vlm"] = replace(cfg.vlm, n_patches=8, mrope_sections=(4, 6, 6))
    if cfg.hybrid_attn_every is not None:
        small["hybrid_attn_every"] = 2
        small["n_layers"] = 4
    small["sketch"] = replace(cfg.sketch, k_counters=64, expert_counters=16,
                              chunk=128, buffer_depth=4, merge_every=4)
    small["param_dtype"] = "float32"
    small["compute_dtype"] = "float32"
    small.update(overrides)
    return replace(cfg, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
