"""repro_torch.models.model (the dense GQA family) against repro.models.model.

The JAX package's ``init_params`` weights are carried over with
``models/convert.py`` (whose round trip is exact), and the same numpy
tokens go through both forwards at the smoke sizes (f32). Tolerances:

  * forward logits and loss against JAX: 2e-5 absolute on logits of order
    1–5. Both sides run the same f32 operations in the same order; only the
    summation order inside each matmul and einsum differs (XLA against
    ATen), a few f32 ulps a product, over two layers.
  * decode against forward, within the port: JAX's own 5e-4
    (``tests/test_models_smoke.py``): the blockwise softmax and the
    decode path's analytic merge of the new token sum in other orders.

The MLA and MoE families are held in ``test_torch_lm_mla.py`` and
``test_torch_lm_moe.py``; the ssm, hybrid, audio and vlm families raise
NotImplementedError.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.models import model as JM
from repro_torch.configs.registry import ARCHS, get_arch, get_smoke_arch
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax

torch.set_num_threads(1)
DENSE = ["qwen2.5-14b", "yi-34b", "qwen1.5-110b"]
PORTED = DENSE + ["minicpm3-4b", "qwen3-moe-30b-a3b", "mixtral-8x7b"]
B, S = 2, 32
ATOL = 2e-5


def _models(name, **overrides):
    """(jax cfg, jax params, port cfg, port model) holding the same weights."""
    jcfg, cfg = jax_smoke_arch(name, **overrides), get_smoke_arch(name, **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


def _tokens(cfg, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, s)).astype(np.int32)


@pytest.mark.parametrize("overrides", [{}, {"q_head_pad": 1}, {"tie_embeddings": True}])
def test_params_from_jax_round_trip(overrides):
    jcfg, jp, cfg, model = _models("qwen2.5-14b", **overrides)
    tree = jax.tree.map(np.asarray, jp)
    sd = params_from_jax(cfg, tree)
    assert sd.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    back = params_to_jax(cfg, model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_params_from_jax_carries_bf16_bits():
    cfg = get_smoke_arch("qwen2.5-14b", param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = jax_smoke_arch("qwen2.5-14b", param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    sd = params_from_jax(cfg, tree)
    assert sd["embed"].dtype == torch.bfloat16
    back = params_to_jax(cfg, sd)
    assert np.array_equal(back["layers"]["wq"].view(np.uint16),
                          tree["layers"]["wq"].view(np.uint16))


@pytest.mark.parametrize("name,overrides", [(n, {}) for n in DENSE]
                         + [("qwen2.5-14b", {"swa_window": 8}),
                            ("yi-34b", {"q_head_pad": 1})])
def test_forward_and_loss_equal_jax(name, overrides):
    jcfg, jp, cfg, model = _models(name, **overrides)
    tok = _tokens(cfg)
    labels = np.roll(tok, -1, axis=1)
    jlogits, _ = JM.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    logits, _ = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    band, _ = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg, schedule="band")
    torch.testing.assert_close(band, logits, rtol=0, atol=ATOL)
    jloss, _ = JM.loss_fn(jp, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)},
                          jcfg)
    loss, aux = M.loss_fn(model, {"tokens": torch.from_numpy(tok),
                                  "labels": torch.from_numpy(labels)}, cfg)
    assert abs(float(loss) - float(jloss)) < ATOL and aux["ce_loss"] is loss


@pytest.mark.parametrize("name,overrides", [(n, {}) for n in DENSE]
                         + [("qwen2.5-14b", {"swa_window": 8})])
def test_decode_matches_forward(name, overrides):
    cfg = get_smoke_arch(name, **overrides)
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(cfg))
    full, _ = M.forward(model, {"tokens": tok}, cfg)
    cache = M.init_cache(cfg, B, S)
    errs = []
    for i in range(S):
        lg, cache, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, (name, max(errs))


def test_prefill_cache_feeds_decode():
    cfg = get_smoke_arch("qwen2.5-14b")
    model = M.init_params(cfg, torch.Generator().manual_seed(1))
    tok = torch.from_numpy(_tokens(cfg, seed=1))
    full, _ = M.forward(model, {"tokens": tok}, cfg)
    half = S // 2
    _, aux = M.forward(model, {"tokens": tok[:, :half]}, cfg, collect=True)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, S - half))
             for k, v in aux["cache"].items()}
    for i in range(half, S):
        lg, cache, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        err = float((lg[:, 0] - full[:, i]).abs().max())
        assert err < 5e-4, (i, err)


def test_prefill_cache_equals_jax():
    jcfg, jp, cfg, model = _models("qwen2.5-14b")
    tok = _tokens(cfg)
    _, jaux = JM.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg, collect=True)
    _, aux = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg, collect=True)
    for name in ("k", "v"):
        np.testing.assert_allclose(aux["cache"][name].numpy(),
                                   np.asarray(jaux["cache"][name]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", DENSE + ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_cache_shapes_equal_jax(name, smoke):
    cfg, jcfg = ((get_smoke_arch(name), jax_smoke_arch(name)) if smoke
                 else (get_arch(name), jax_arch(name)))
    ours, theirs = M.cache_shapes(cfg, 4, 96), JM.cache_shapes(jcfg, 4, 96)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].device.type == "meta"
        assert tuple(ours[k].shape) == theirs[k].shape
        assert str(ours[k].dtype).removeprefix("torch.") == str(theirs[k].dtype)
    cache = M.init_cache(cfg, 2, 8, device="meta" if not smoke else "cpu")
    assert {k: c.shape for k, c in cache.items()} == \
        {k: (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd) for k in ours}
    if smoke:
        assert all(not c.any() for c in cache.values())


def test_init_params_scales_and_seed():
    cfg = get_smoke_arch("qwen2.5-14b", n_layers=4, q_head_pad=1)
    a = M.init_params(cfg, torch.Generator().manual_seed(3))
    b = M.init_params(cfg, torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    blk = a.layers[0]
    hq_hd = cfg.n_q_heads * cfg.hd
    real = blk.attn.wo.reshape(cfg.n_kv_heads, -1, cfg.hd, cfg.d_model)[:, :-1]
    assert abs(float(real.std()) / (hq_hd ** -0.5 / (2 * cfg.n_layers) ** 0.5) - 1) < 0.05
    assert abs(float(a.embed.std()) - 1.0) < 0.02
    assert abs(float(blk.mlp.w_down.std()) * cfg.d_ff ** 0.5 - 1) < 0.05
    # the q-head pads: zero wq columns and zero wo rows, as JAX's init
    pad = blk.attn.wq.reshape(cfg.d_model, cfg.n_kv_heads, -1, cfg.hd)[:, :, -1]
    assert not pad.any()
    assert not blk.attn.wo.reshape(cfg.n_kv_heads, -1, cfg.hd, cfg.d_model)[:, -1].any()
    assert not blk.attn.bq.any() and bool((blk.attn_norm.scale == 1).all())


@pytest.mark.parametrize("name", [n for n in ARCHS if n not in PORTED])
def test_other_families_raise(name):
    cfg = get_smoke_arch(name)
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 3\(b\)"):
        M.build_params(cfg, "meta")
    with pytest.raises(NotImplementedError):
        M.param_count(cfg)
    with pytest.raises(NotImplementedError):
        M.cache_shapes(cfg, 1, 8)
    dense = get_smoke_arch("qwen2.5-14b")
    with pytest.raises(NotImplementedError):
        M.forward(M.build_params(dense, "meta"), {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                  dataclasses.replace(dense, family=cfg.family, mla=cfg.mla, moe=cfg.moe))
