"""The audio family (whisper-tiny: an encoder-decoder with cross attention)
against repro, on the CPU at f32, serving side and gradients.

whisper-tiny's smoke arch (2 encoder and 2 decoder layers, d 128, 32
frames), with the JAX package's ``init_params(PRNGKey(0))`` carried over
by ``models/convert.py`` and the same seeded numpy tokens and frames in
both packages. Tolerances:

  * logits and loss within 2e-5 (``test_torch_lm_model.ATOL``): the same
    f32 operations, summed in other orders inside each product by XLA and
    ATen, over two encoder and two decoder layers;
  * the gradient of every leaf within 1e-4 of that leaf's largest entry
    (plus 1e-8): the backward adds one more pass of f32 sums in other
    orders, and through the cross attention the encoder's gradient sums
    over every decoder position (measured: 1.3e-6 at most). The key
    biases' gradients are 0 in exact arithmetic (a softmax does not see a
    shift that every key shares): both packages give noise under 1e-8;
  * the prefill cache (k, v, ck, cv) within 2e-5 (its entries are those
    of the forward's products, of order 1);
  * decode from the prefill cache against JAX's ``decode_step`` within
    2e-5 after every step (logits and the written k/v), and against the
    forward within JAX's own 5e-4 (``tests/test_models_smoke.py``): the
    blockwise softmax and the decode softmax sum in other orders.

``param_count`` and ``cache_shapes`` are held at full and smoke size in
``test_torch_configs.py`` and ``test_torch_lm_model.py``; the train steps,
the CLI and the cross-package resume in ``test_torch_lm_audio_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import model as JM
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro.train import steps as JS
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax, stack_params
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import steps as S

torch.set_num_threads(1)
ARCH = "whisper-tiny"
B, S_LEN = 2, 32
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port model) holding the same weights."""
    jcfg, cfg = jax_smoke_arch(ARCH), get_smoke_arch(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


def _batch(cfg, s=S_LEN, seed=0) -> dict:
    """Tokens, labels and frames (B, n_frames, D) of order 0.02, numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.enc_dec.n_frames, cfg.d_model)) * 0.02)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1),
            "frames": frames.astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_params_round_trip_and_layout(models):
    jcfg, jp, cfg, model = models
    tree = jax.tree.map(np.asarray, jp)
    assert {"enc_layers", "dec_layers", "enc_final_norm_scale",
            "enc_final_norm_bias"} <= set(tree)
    assert {f"cross_{n}" for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")} | \
        {"cross_norm_scale", "cross_norm_bias"} <= set(tree["dec_layers"])
    sd = params_from_jax(cfg, tree)
    assert sd.keys() == model.state_dict().keys()
    assert sd["layers.1.cross_attn.bk"].shape == tree["dec_layers"]["cross_bk"].shape[1:]
    assert len(model.encoder.layers) == cfg.enc_dec.n_enc_layers == 2
    assert not hasattr(model.encoder.layers[0], "cross_attn")
    back = params_to_jax(cfg, model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_scales_as_jax():
    """``wo``'s scale takes the decoder's depth in both stacks; biases zero,
    LayerNorms ones and zeros."""
    cfg = get_smoke_arch(ARCH, n_layers=4)
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    want = (cfg.n_q_heads * cfg.hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5
    for attn in (model.encoder.layers[0].attn, model.layers[0].attn, model.layers[0].cross_attn):
        assert abs(float(attn.wo.std()) / want - 1) < 0.1
        assert not attn.bq.any() and not attn.bv.any()
    norm = model.encoder.final_norm
    assert bool((norm.scale == 1).all()) and not norm.bias.any()
    assert not model.layers[0].mlp.b_up.any()


def test_forward_and_loss_equal_jax(models):
    jcfg, jp, cfg, model = models
    batch = _batch(cfg)
    jlogits, _ = JM.forward(jp, _j(batch), jcfg)
    logits, aux = M.forward(model, _t(batch), cfg)
    assert aux == {} and logits.dtype == torch.float32 and logits.shape == (B, S_LEN, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    jloss, _ = JM.loss_fn(jp, _j(batch), jcfg)
    loss, _ = M.loss_fn(model, _t(batch), cfg)
    assert abs(float(loss) - float(jloss)) < ATOL
    # the frames matter: other frames, other logits
    other = dict(batch, frames=batch["frames"][::-1].copy())
    assert float((M.forward(model, _t(other), cfg)[0] - logits).abs().max()) > 1e-3


def test_grads_equal_jax(models):
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, seed=1)
    jgrads = jax.grad(lambda p: JM.loss_fn(p, _j(batch), jcfg)[0])(jp)
    model.requires_grad_(True)
    try:
        loss, _ = M.loss_fn(model, _t(batch), cfg)
        loss.backward()
        grads = stack_params(cfg, {n: p.grad for n, p in model.named_parameters()})
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), grads)) == \
        jax.tree.structure(jgrads)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, want), got in zip(flat, jax.tree.leaves(grads)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_policies_give_the_same_loss_and_grads():
    """Both stacks under every policy (nested maps to a checkpoint a
    layer): the same loss and grads as no remat, bit for bit."""
    cfg = get_smoke_arch(ARCH)
    model = M.init_params(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    batch = _t(_batch(cfg, seed=2))
    runs = {}
    for remat in ("none", "full", "dots", "nested:2"):
        model.zero_grad(set_to_none=True)
        loss, _ = M.loss_fn(model, batch, dataclasses.replace(cfg, remat=remat))
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    loss0, g0 = runs.pop("none")
    for remat, (loss, g) in runs.items():
        assert torch.equal(loss, loss0), remat
        for n in g0:
            assert torch.equal(g[n], g0[n]), (remat, n)
    assert g0["encoder.layers.0.attn.wq"].abs().max() > 0
    assert g0["layers.0.cross_attn.wk"].abs().max() > 0


def test_prefill_cache_equals_jax(models):
    """k, v (L, B, S, KV, hd) and ck, cv (L, B, n_frames, KV, hd), as
    JAX's ``forward(collect=True)`` and ``cache_shapes``."""
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, seed=3)
    del batch["labels"]
    jlast, jcache = JS.make_prefill_step(jcfg, JShardingPlan(jcfg, None))(jp, _j(batch))
    last, cache = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, _t(batch))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    shapes = M.cache_shapes(cfg, B, S_LEN)
    assert cache.keys() == jcache.keys() == shapes.keys() == {"k", "v", "ck", "cv"}
    for name, t in cache.items():
        assert tuple(t.shape) == jcache[name].shape == tuple(shapes[name].shape), name
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=0, atol=ATOL,
                                   err_msg=name)
    assert cache["ck"].shape[2] == cfg.enc_dec.n_frames


def test_decode_from_the_prefill_cache_equals_jax_and_the_forward(models):
    """A 16-token prefill padded to 32 by the launcher, then 16 decode
    steps: each step's logits and cache against JAX's decode from JAX's
    prefill cache, and against the forward over the 32 tokens; ck/cv come
    back unchanged."""
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, seed=4)
    full, _ = M.forward(model, _t(batch), cfg)
    half = S_LEN // 2
    pre = {"tokens": batch["tokens"][:, :half], "frames": batch["frames"]}
    _, jcache = JS.make_prefill_step(jcfg, JShardingPlan(jcfg, None))(jp, _j(pre))
    _, cache = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, _t(pre))
    cache = serve_cli.pad_cache(cache, S_LEN)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, S_LEN - half), (0, 0), (0, 0)])
              if k in ("k", "v") else v for k, v in jcache.items()}
    ck = cache["ck"].clone()
    errs = []
    for i in range(half, S_LEN):
        tok = batch["tokens"][:, i:i + 1]
        jl, jcache, _ = JM.decode_step(jp, jcache, jnp.asarray(tok), i, jcfg)
        lg, out, aux = M.decode_step(model, cache, torch.from_numpy(tok), i, cfg)
        assert out is cache and aux == {}
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        for name, t in cache.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=0, atol=ATOL,
                                       err_msg=name)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, max(errs)
    assert torch.equal(cache["ck"], ck)


def test_frames_of_the_wrong_length_are_refused(models):
    _, _, cfg, model = models
    batch = _t(_batch(cfg))
    for n in (1, cfg.enc_dec.n_frames - 1, cfg.enc_dec.n_frames + 8):
        bad = dict(batch, frames=batch["frames"][:, :1].expand(B, n, cfg.d_model))
        with pytest.raises(ValueError, match="frames"):
            M.forward(model, bad, cfg)
    with pytest.raises(KeyError):
        M.forward(model, {"tokens": batch["tokens"]}, cfg)


def test_pad_cache_keeps_ck_cv_at_n_frames(models):
    _, _, cfg, model = models
    batch = _batch(cfg, s=16, seed=5)
    del batch["labels"]
    _, pre = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, _t(batch))
    padded = serve_cli.pad_cache(pre, 40)
    shapes = M.cache_shapes(cfg, B, 40)
    for n, t in padded.items():
        assert tuple(t.shape) == tuple(shapes[n].shape), n
        if n in ("k", "v"):
            assert torch.equal(t[:, :, :16], pre[n]) and not t[:, :, 16:].any()
        else:
            assert t is pre[n]
    assert {"ck", "cv"}.isdisjoint(serve_cli.SEQ_CACHES)


def test_run_serve_draws_the_frames_in_the_jax_order(models, monkeypatch):
    """run_serve's prefill logits equal JAX's prefill over the JAX
    launcher's batch (``data.next()``, then ``data.extras(cfg)``), and
    the cache its decode loop receives keeps ck/cv at n_frames."""
    jcfg, jp, cfg, model = models
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(cfg.sketch, kernel="sorted"))
    seen = []
    real = S.make_serve_step

    def recording(*args, **kw):
        step = real(*args, **kw)

        def serve(model_, cache, *rest):
            seen.append({n: tuple(t.shape) for n, t in cache.items()})
            return step(model_, cache, *rest)
        return serve
    monkeypatch.setattr(S, "make_serve_step", recording)
    out = serve_cli.run_serve(cfg, batch=B, prompt_len=16, gen=6, report_every=3,
                              device="cpu", model=model)
    data = JTokenStream(jcfg.vocab, B, 16)
    host = data.next()
    host.update(data.extras(jcfg))
    np.testing.assert_array_equal(out["prompt"], host["tokens"])
    jlast, _ = JS.make_prefill_step(jcfg, JShardingPlan(jcfg, None))(jp, _j(host))
    np.testing.assert_allclose(out["prefill_logits"].numpy(), np.asarray(jlast), rtol=0,
                               atol=ATOL)
    kv = (cfg.n_layers, B, 22, cfg.n_kv_heads, cfg.hd)
    cross = (cfg.n_layers, B, cfg.enc_dec.n_frames, cfg.n_kv_heads, cfg.hd)
    assert seen == [{"k": kv, "v": kv, "ck": cross, "cv": cross}] * 6
    assert out["tokens"].shape == (B, 6) and len(out["reports"]) == 2
