"""The 10 assigned architectures (exact configs from the assignment table)
plus the paper's own stream-mining configuration.

A copy of ``repro.configs.registry``; the port's model runs the dense GQA
family (qwen2.5-14b, yi-34b, qwen1.5-110b) so far.

Each entry is selectable via ``--arch <id>`` in the launchers. Sources are
noted per config; verified tiers per the assignment brackets.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, EncDecConfig, MLAConfig,
                                MoEConfig, SHAPES, SSMConfig, SketchConfig,
                                VLMConfig, scaled)

# [hf:Qwen/Qwen2.5-0.5B; hf] — GQA, QKV bias
QWEN2_5_14B = ArchConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0)

# [arXiv:2403.04652; hf] — llama-arch GQA
YI_34B = ArchConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, rope_theta=5_000_000.0)

# [hf:Qwen/Qwen1.5-0.5B; hf] — QKV bias
QWEN1_5_110B = ArchConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0)

# [hf:openbmb/MiniCPM3-4B; hf] — MLA
MINICPM3_4B = ArchConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=6400, vocab=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64))

# [arXiv:2405.21060; unverified] — SSD (state-space duality)
MAMBA2_130M = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=24, n_kv_heads=24, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, n_groups=1,
                  chunk=256))

# [arXiv:2411.15242; unverified] — Mamba2 + shared attn blocks
ZAMBA2_7B = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, n_groups=2,
                  chunk=256))

# [arXiv:2212.04356; unverified] — enc-dec, conv frontend (stub)
WHISPER_TINY = ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, qkv_bias=True,
    norm_type="layernorm", act="gelu",
    enc_dec=EncDecConfig(n_enc_layers=4, n_frames=1500))

# [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution (patch embeds stubbed)
QWEN2_VL_72B = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, vlm=VLMConfig(n_patches=256,
                                          mrope_sections=(16, 24, 24)))

# [hf:Qwen/Qwen3-30B-A3B; hf] — 128 experts top-8 (explicit head_dim=128)
QWEN3_MOE_30B_A3B = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  router_norm_topk=True))

# [arXiv:2401.04088; hf] — 8 experts top-2, sliding-window attention
MIXTRAL_8X7B = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, swa_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336))

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    QWEN2_5_14B, YI_34B, QWEN1_5_110B, MINICPM3_4B, MAMBA2_130M, ZAMBA2_7B,
    WHISPER_TINY, QWEN2_VL_72B, QWEN3_MOE_30B_A3B, MIXTRAL_8X7B,
]}

# The paper's own experiment configuration (§4, Table I) — stream mining only.
PAPER_STREAM_CONFIGS = {
    "paper-default": dict(k_counters=2000, skew=1.1, n_items=10_000_000),
    "paper-k-sweep": dict(k_counters=[500, 1000, 2000, 4000, 8000], skew=1.1),
    "paper-skew-sweep": dict(k_counters=2000, skew=[1.1, 1.8]),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_arch(name: str, **overrides) -> ArchConfig:
    return scaled(get_arch(name), **overrides)


# long_500k eligibility (DESIGN.md §4): sub-quadratic archs only.
def shape_cells(arch: ArchConfig):
    """The assigned (shape) cells for an arch, with documented skips."""
    cells = []
    for shape in SHAPES.values():
        if shape.name == "long_500k" and not arch.subquadratic:
            cells.append((shape, "skip: pure full-attention arch (DESIGN.md §4)"))
        else:
            cells.append((shape, None))
    return cells
