"""The vlm family (qwen2-vl-72b: the dense GQA branch with M-RoPE and stub
patch embeddings) against repro, on the CPU at f32, serving and training.

qwen2-vl-72b's smoke arch (2 layers, d 128, 8 patches, M-RoPE sections
(4, 6, 6)), with the JAX package's ``init_params(PRNGKey(0))`` carried
over by ``models/convert.py`` and the same seeded numpy inputs in both
packages. Tolerances as ``test_torch_lm_audio.py``'s: logits, loss and the
prefill cache within 2e-5; every gradient leaf within 1e-4 of its largest
entry (plus 1e-8; the key biases' gradients are 0 in exact arithmetic);
decode against JAX's within 2e-5 and against the forward within JAX's
5e-4; three train steps under full, dots and nested:2 remat against JAX's
jitted ``make_train_step`` with the loss within 1e-5 and grad norm within
1e-4 relative and params within the sign bound (2·Σlr + 1e-5, fewer than
0.1% off by more than 1e-5), the token sketch bitwise.

The vision embeddings overwrite prompt rows 0..n_patches-1, so decode can
only reproduce the positions after them: the decode checks start after a
prompt that holds them.
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
from repro.optim import adamw as jadamw
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro.train import steps as JS
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import state_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax, stack_params
from repro_torch.optim import adamw
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import steps as S

torch.set_num_threads(1)
ARCH = "qwen2-vl-72b"
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


def _batch(cfg, s=S_LEN, seed=0, vision=True, positions=None) -> dict:
    """Tokens and labels, the patch embeddings (B, n_patches, D) of order
    0.02 unless ``vision`` is False, and ``positions`` (3, B, S) if given:
    'arange' (the stream's) or 'random' (t/h/w rows that differ)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if vision:
        ve = rng.standard_normal((B, cfg.vlm.n_patches, cfg.d_model)) * 0.02
        batch["vision_embeds"] = ve.astype(np.float32)
    if positions == "arange":
        batch["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32), (3, B, s)).copy()
    elif positions == "random":
        batch["positions"] = rng.integers(0, 4 * s, (3, B, s)).astype(np.int32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_params_round_trip(models):
    jcfg, jp, cfg, model = models
    tree = jax.tree.map(np.asarray, jp)
    sd = params_from_jax(cfg, tree)
    assert sd.keys() == model.state_dict().keys()
    assert "layers.0.attn.bq" in sd and model.encoder is None
    back = params_to_jax(cfg, model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("vision,positions", [(True, None), (False, None), (True, "arange"),
                                              (True, "random")])
def test_forward_and_loss_equal_jax(models, vision, positions):
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, vision=vision, positions=positions)
    jlogits, _ = JM.forward(jp, _j(batch), jcfg)
    logits, _ = M.forward(model, _t(batch), cfg)
    assert logits.shape == (B, S_LEN, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    jloss, _ = JM.loss_fn(jp, _j(batch), jcfg)
    loss, _ = M.loss_fn(model, _t(batch), cfg)
    assert abs(float(loss) - float(jloss)) < ATOL
    if positions == "arange":       # the default positions are the stream's
        del batch["positions"]
        assert torch.equal(M.forward(model, _t(batch), cfg)[0], logits)
    if positions == "random":       # each of the three position streams matters
        for row in range(3):        # (one token's: RoPE sees only differences)
            moved = dict(batch, positions=batch["positions"].copy())
            moved["positions"][row, :, 5] += 7
            assert float((M.forward(model, _t(moved), cfg)[0] - logits).abs().max()) > 1e-4
    if vision:     # the embeddings replace the first n_patches rows' tokens
        n = cfg.vlm.n_patches
        other = dict(batch, tokens=batch["tokens"].copy())
        other["tokens"][:, :n] = (other["tokens"][:, :n] + 1) % cfg.vocab
        assert torch.equal(M.forward(model, _t(other), cfg)[0], logits)


def test_grads_equal_jax(models):
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, seed=1, positions="random")
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
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_cache_equals_jax(models):
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, seed=2, positions="random")
    del batch["labels"]
    jlast, jcache = JS.make_prefill_step(jcfg, JShardingPlan(jcfg, None))(jp, _j(batch))
    last, cache = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, _t(batch))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    shapes = M.cache_shapes(cfg, B, S_LEN)
    assert cache.keys() == jcache.keys() == shapes.keys() == {"k", "v"}
    for name, t in cache.items():
        assert tuple(t.shape) == jcache[name].shape == tuple(shapes[name].shape), name
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_decode_from_the_prefill_cache_equals_jax_and_the_forward(models):
    """A 16-token prefill (its first 8 rows the patch embeddings) padded to
    32 by the launcher, then 16 decode steps: each step's logits and cache
    against JAX's decode from JAX's prefill cache, and against the forward
    over the 32 tokens with the same embeddings."""
    jcfg, jp, cfg, model = models
    batch = _batch(cfg, seed=3)
    full, _ = M.forward(model, _t(batch), cfg)
    half = S_LEN // 2
    pre = {"tokens": batch["tokens"][:, :half], "vision_embeds": batch["vision_embeds"]}
    _, jcache = JS.make_prefill_step(jcfg, JShardingPlan(jcfg, None))(jp, _j(pre))
    _, cache = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, _t(pre))
    cache = serve_cli.pad_cache(cache, S_LEN)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, S_LEN - half), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    errs = []
    for i in range(half, S_LEN):
        tok = batch["tokens"][:, i:i + 1]
        jl, jcache, _ = JM.decode_step(jp, jcache, jnp.asarray(tok), i, jcfg)
        lg, cache, _ = M.decode_step(model, cache, torch.from_numpy(tok), i, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        for name, t in cache.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=0, atol=ATOL,
                                       err_msg=name)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, max(errs)


def test_more_patches_than_positions_are_refused(models):
    _, _, cfg, model = models
    n = cfg.vlm.n_patches
    batch = _t(_batch(cfg, s=n - 1))
    with pytest.raises(ValueError, match="n_patches"):
        M.forward(model, batch, cfg)
    ok = _t(_batch(cfg, s=n))           # exactly n_patches: every row an embedding
    M.forward(model, ok, cfg)
    with pytest.raises(ValueError, match="patch embeddings"):
        serve_cli.run_serve(cfg, batch=B, prompt_len=n - 1, gen=2, device="cpu", model=model)


def test_run_serve_draws_the_extras_in_the_jax_order(models):
    """run_serve's prefill logits equal JAX's prefill over the JAX
    launcher's batch (``data.next()``, then ``data.extras(cfg)``: the patch
    embeddings and the (3, B, S) positions)."""
    jcfg, jp, cfg, model = models
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(cfg.sketch, kernel="sorted"))
    out = serve_cli.run_serve(cfg, batch=B, prompt_len=16, gen=6, report_every=3,
                              device="cpu", model=model)
    data = JTokenStream(jcfg.vocab, B, 16)
    host = data.next()
    host.update(data.extras(jcfg))
    assert host["positions"].shape == (3, B, 16)
    np.testing.assert_array_equal(out["prompt"], host["tokens"])
    jlast, _ = JS.make_prefill_step(jcfg, JShardingPlan(jcfg, None))(jp, _j(host))
    np.testing.assert_allclose(out["prefill_logits"].numpy(), np.asarray(jlast), rtol=0,
                               atol=ATOL)
    assert out["tokens"].shape == (B, 6) and len(out["reports"]) == 2


def _pin(c, **kw):
    return dataclasses.replace(c, sketch=dataclasses.replace(c.sketch, kernel="sorted"), **kw)


def _assert_params_close(want, got, lr_sum):
    """Leaves of two trees in the JAX layout: within the sign bound."""
    bound = 2 * lr_sum + 1e-5
    n_off = n_all = 0
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert d.max() <= bound, (d.max(), bound)
        n_off += int((d > 1e-5).sum())
        n_all += d.size
    assert n_off < 1e-3 * n_all, (n_off, n_all)


@pytest.mark.parametrize("remat", ["full", "dots", "nested:2"])
def test_train_steps_equal_jax(remat):
    """The stream's batches with their extras: the train step takes the
    (3, B, S) positions and the patch embeddings."""
    cfg = _pin(get_smoke_arch(ARCH), remat=remat)
    jcfg = _pin(jax_smoke_arch(ARCH), remat=remat)
    jplan, plan = JShardingPlan(jcfg, None), ShardingPlan(cfg)
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0), jplan)
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params)))
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), plan, device="cpu",
                               model=model)
    jstep = jax.jit(JS.make_train_step(jcfg, jplan, lr_fn=jadamw.cosine_schedule(1e-3, 2, 10)))
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(1e-3, 2, 10), device="cpu")
    data = TokenStream(cfg.vocab, 4, 64)
    lr_sum = 0.0
    for _ in range(3):
        host = data.next()
        host.update(data.extras(cfg))
        assert host["positions"].shape == (3, 4, 64)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in host.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
        lr_sum += float(m["lr"])
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= 1e-5
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-4
        _assert_params_close(jstate.params, S.checkpoint_tree(cfg, state).params, lr_sum)
        for a, b in zip(jax.tree.leaves(jstate.token_sketch),
                        state_to_numpy(state.token_sketch)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert int(state.opt.count) == 3


def test_train_cli_runs_the_vlm_family(tmp_path):
    out = train_cli.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "4",
                          "--batch", "2", "--seq", "32", "--merge-every", "2",
                          "--log-every", "2", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert out["final"].recall == 1.0 and out["final"].precision == 1.0
    assert (tmp_path / ARCH / "step_00000004" / "manifest.json").exists()
