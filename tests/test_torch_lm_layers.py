"""repro_torch.models' layers against repro.models' at f32 on the CPU.

The same numpy inputs go through both packages: interleaved RoPE and
M-RoPE, RMSNorm and LayerNorm, the SwiGLU and GELU MLPs, the blockwise
prefill attention (causal, a sliding window, GQA groups > 1, q-head pads,
blocks that split the sequence, the band schedule against the masked one)
and both decode attentions. Tolerance: 1e-5 absolute on outputs of order 1
(2e-5 where a product over d = 128 comes first). Both sides compute in f32
with the same operations in the same order; only the summation order
inside a matmul, an einsum or a mean differs (XLA against ATen), which
moves a result by a few f32 ulps (~1e-7 relative each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.models import attention as attn
from repro_torch.models import layers, rope

torch.set_num_threads(1)
ATOL = 1e-5


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(theirs, ours, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=0, atol=atol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_equals_jax(rng, theta):
    jx, tx = _pair(rng, (2, 24, 4, 32))
    pos = rng.integers(0, 40_000, (2, 24)).astype(np.int32)
    _close(jrope.apply_rope(jx, jnp.asarray(pos), theta),
           rope.apply_rope(tx, torch.from_numpy(pos), theta), atol=2e-5)
    # interleaved pairs: (x[2i], x[2i+1]) rotate together, not the halves
    out = rope.apply_rope(tx, torch.ones((2, 24), dtype=torch.int32), theta)
    a = torch.atan2(out[..., 1], out[..., 0]) - torch.atan2(tx[..., 1], tx[..., 0])
    assert torch.allclose(torch.remainder(a + np.pi, 2 * np.pi) - np.pi,
                          torch.tensor(1.0), atol=1e-4)


def test_mrope_equals_jax(rng):
    jx, tx = _pair(rng, (2, 12, 3, 32))
    pos = rng.integers(0, 500, (3, 2, 12)).astype(np.int32)
    _close(jrope.apply_mrope(jx, jnp.asarray(pos), 1e6, (4, 6, 6)),
           rope.apply_mrope(tx, torch.from_numpy(pos), 1e6, (4, 6, 6)))


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norms_equal_jax(rng, norm_type):
    jx, tx = _pair(rng, (3, 7, 128), scale=3.0)
    js, ts = _pair(rng, (128,))
    jb, tb = _pair(rng, (128,))
    p = {"n_scale": js, "n_bias": jb}
    norm = layers.make_norm(128, norm_type, 1e-6, dtype=torch.float32)
    norm.scale.data.copy_(ts)
    if norm_type == "layernorm":
        norm.bias.data.copy_(tb)
    _close(jlayers.apply_norm(p, "n", jx, norm_type, 1e-6), norm(tx))
    # computed in f32, cast back to the input's dtype
    assert norm(tx.to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlps_equal_jax(rng, act):
    mlp = layers.MLP(128, 256, act, dtype=torch.float32)
    p = {}
    for name, param in mlp.named_parameters():
        jv, tv = _pair(rng, tuple(param.shape), scale=0.1)
        p[name] = jv
        param.data.copy_(tv)
    jx, tx = _pair(rng, (2, 9, 128))
    _close(jlayers.apply_mlp(p, jx, act), mlp(tx), atol=2e-5)


def test_sinusoidal_positions_equal_jax():
    _close(jlayers.sinusoidal_positions(50, 64), layers.sinusoidal_positions(50, 64))


def _attn_pair(rng, name="qwen2.5-14b", **overrides):
    """A JAX attn_params dict and the port's Attention holding its bits."""
    jcfg = jax_smoke_arch(name, **overrides)
    cfg = get_smoke_arch(name, **overrides)
    ctx = jlayers.Ctx(mode="init", key=jax.random.PRNGKey(int(rng.integers(1 << 30))),
                      dtype=jnp.float32)
    p = jattn.attn_params(ctx, jcfg)
    if jcfg.qkv_bias:  # nonzero biases, so the test sees them
        p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    mod = attn.Attention(cfg, dtype=torch.float32)
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return jcfg, cfg, p, mod


@pytest.mark.parametrize("overrides", [{}, {"q_head_pad": 1}, {"n_kv_heads": 1}])
def test_project_qkv_and_pad_mask_equal_jax(rng, overrides):
    jcfg, cfg, p, mod = _attn_pair(rng, **overrides)
    jx, tx = _pair(rng, (2, 16, cfg.d_model))
    jq, jk, jv = jattn.project_qkv(p, jx, jcfg)
    q, k, v = attn.project_qkv(mod, tx, cfg)
    for a, b in ((jq, q), (jk, k), (jv, v)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, atol=2e-5)
    jo = jattn.blockwise_attention(jq, jk, jv, block_q=8, block_kv=8)
    o = attn.blockwise_attention(q, k, v, block_q=8, block_kv=8)
    _close(jattn.mask_pad_heads(jo, jcfg), attn.mask_pad_heads(o, cfg))
    if cfg.q_head_pad:
        assert not attn.mask_pad_heads(o, cfg).reshape(2, 16, cfg.n_kv_heads, -1, cfg.hd)[
            :, :, :, -1].any()


BLOCKWISE = [
    # (sq, skv, h, kvh, hd, causal, window, block, q_offset)
    (32, 32, 4, 4, 32, True, None, 512, 0),     # one block
    (32, 32, 4, 2, 32, True, None, 8, 0),       # GQA groups 2, 4 blocks
    (48, 48, 8, 2, 16, True, 12, 16, 0),        # a window across blocks
    (24, 24, 4, 1, 32, False, None, 8, 0),      # non-causal, MQA
    (16, 48, 4, 2, 32, True, None, 16, 32),     # a chunk at q_offset
    (30, 30, 4, 4, 32, True, 7, 10, 0),         # blocks that are not powers of two
]


@pytest.mark.parametrize("case", BLOCKWISE)
def test_blockwise_attention_equals_jax(rng, case):
    sq, skv, h, kvh, hd, causal, window, block, q_offset = case
    jq, q = _pair(rng, (2, sq, h, hd))
    jk, k = _pair(rng, (2, skv, kvh, hd))
    jv, v = _pair(rng, (2, skv, kvh, hd))
    kw = dict(causal=causal, window=window, block_q=block, block_kv=block,
              q_offset=q_offset)
    want = jattn.blockwise_attention(jq, jk, jv, **kw)
    got = attn.blockwise_attention(q, k, v, **kw)
    _close(want, got)
    band = attn.blockwise_attention(q, k, v, schedule="band", **kw)
    _close(jattn.blockwise_attention(jq, jk, jv, schedule="band", **kw), band)
    torch.testing.assert_close(band, got, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("kvh", [4, 1])
def test_decode_attentions_equal_jax(rng, window, kvh):
    s, h, hd, position = 20, 4, 32, 13
    jq, q = _pair(rng, (2, 1, h, hd))
    jkc, kc = _pair(rng, (2, s, kvh, hd))
    jvc, vc = _pair(rng, (2, s, kvh, hd))
    jkn, kn = _pair(rng, (2, 1, kvh, hd))
    jvn, vn = _pair(rng, (2, 1, kvh, hd))
    _close(jattn.decode_attention(jq, jkc, jvc, position + 1, window=window),
           attn.decode_attention(q, kc, vc, position + 1, window=window))
    _close(jattn.decode_attention_plus_one(jq, jkc, jvc, jkn, jvn, position, window=window),
           attn.decode_attention_plus_one(q, kc, vc, kn, vn, position, window=window))
    # the plus-one form is the cache form with the new kv written at position
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, position:position + 1], vc2[:, position:position + 1] = kn, vn
    torch.testing.assert_close(
        attn.decode_attention_plus_one(q, kc, vc, kn, vn, position, window=window),
        attn.decode_attention(q, kc2, vc2, position + 1, window=window), rtol=0, atol=ATOL)


def test_merge_heads_equals_jax(rng):
    jx, tx = _pair(rng, (2, 3, 4, 8))
    _close(jattn.merge_heads(jx), attn.merge_heads(tx), atol=0)
