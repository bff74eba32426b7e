"""repro_torch.models.mamba2 and the SSM (mamba2-130m) and hybrid
(zamba2-7b) families against repro, on the CPU at f32, serving side.

The JAX package's weights are carried over (``load_state_dict`` of a
``mamba_params`` dict, or ``models/convert.py`` for a whole model) and the
same seeded numpy inputs go through both packages. Tolerances:

  * ``ssd_scan`` against JAX's within 1e-5 of the output's largest entry,
    and against the naive float64 recurrence of ``tests/test_mamba2.py``
    within JAX's own 1e-3: the same f32 products, contracted in other
    orders (the port splits JAX's three-operand einsums into two-operand
    products);
  * ``causal_conv`` within 1e-6, ``mamba_block`` and ``mamba_decode_step``
    within 1e-5 (outputs, states and the conv window, whose entries are
    ``x @ in_proj``'s, of order 1–10);
  * the smoke archs' logits and loss within 2e-5 (``test_torch_lm_model.
    ATOL``), their caches within 1e-4 (an SSD state sums a whole prompt);
  * decode against the forward, within the port: JAX's 5e-4
    (``tests/test_models_smoke.py``); decode against JAX's decode, logits
    within 2e-5 and the caches within 1e-4 after every step.

``param_count`` is equal, the weight round trip and the launcher's cache
padding are bitwise, and a prompt cache padded by the launcher decodes to
the same tokens as one built at full length by hand.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.models import mamba2 as JMB
from repro.models import model as JM
from repro.models.layers import Ctx
from repro_torch.configs.registry import get_arch, get_smoke_arch
from repro_torch.engine import state_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mamba2
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK
from repro_torch.train import steps as S
from test_mamba2 import naive_ssd

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["mamba2-130m", "zamba2-7b"]
B, S_LEN = 2, 32
ATOL = 2e-5
CACHE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


def _scan_inputs(seed, bsz, l, h, p, n, groups):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((bsz, l, h, p)).astype(f32),
            rng.uniform(0.1, 0.9, (bsz, l, h)).astype(f32),
            -rng.uniform(0.5, 1.5, (h,)).astype(f32),
            rng.standard_normal((bsz, l, groups, n)).astype(f32),
            rng.standard_normal((bsz, l, groups, n)).astype(f32))


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_equals_jax_and_the_recurrence(chunk, groups):
    args = _scan_inputs(chunk * 10 + groups, 2, 32, 4, 8, 16, groups)
    jy, jh = JMB.ssd_scan(*map(jnp.asarray, args), chunk)
    y, h = mamba2.ssd_scan(*map(torch.from_numpy, args), chunk)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jh)).max()))
    np.testing.assert_allclose(y.numpy(), naive_ssd(*args), atol=1e-3, rtol=1e-3)
    assert h.dtype == torch.float32 and h.shape == (2, groups, 4 // groups, 16, 8)


def test_ssd_final_state_continues_the_stream():
    """[s1; s2] in one scan == s1, then s2 from s1's final state."""
    xs, dt, a, b_, c_ = map(torch.from_numpy, _scan_inputs(7, 1, 32, 2, 4, 8, 1))
    y_full, h_full = mamba2.ssd_scan(xs, dt, a, b_, c_, 8)
    _, h1 = mamba2.ssd_scan(xs[:, :16], dt[:, :16], a, b_[:, :16], c_[:, :16], 8)
    y2, h2 = mamba2.ssd_scan(xs[:, 16:], dt[:, 16:], a, b_[:, 16:], c_[:, 16:], 8, h_init=h1)
    torch.testing.assert_close(y2, y_full[:, 16:], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h2, h_full, rtol=1e-4, atol=1e-4)


def test_ssd_scan_refuses_a_ragged_chunk():
    args = map(torch.from_numpy, _scan_inputs(0, 1, 24, 2, 4, 8, 1))
    with pytest.raises(AssertionError):
        mamba2.ssd_scan(*args, 16)


def test_ssd_scan_gradient_is_finite_over_a_long_chunk():
    """A 256-position chunk whose cumulative decay passes e^88 above the
    diagonal: the forward is finite and so is every gradient (the mask is
    taken before the exp)."""
    xs, dt, a, b_, c_ = map(torch.from_numpy, _scan_inputs(3, 1, 256, 2, 4, 8, 1))
    dt = (dt + 1.0).requires_grad_(True)
    y, h = mamba2.ssd_scan(xs, dt, a, b_, c_, 256)
    (y.square().sum() + h.sum()).backward()
    assert float((dt.detach() * -a).sum(1).max()) > 88
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(dt.grad).all())


@pytest.mark.parametrize("k,c", [(4, 40), (2, 7)])
def test_causal_conv_equals_jax(k, c):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 12, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    want = np.asarray(JMB.causal_conv(*map(jnp.asarray, (x, w, b))))
    got = mamba2.causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # causal: the output at t depends on inputs at t and before only
    x2 = x.copy()
    x2[:, 6:] += 1.0
    got2 = mamba2.causal_conv(*map(torch.from_numpy, (x2, w, b)))
    assert torch.equal(got2[:, :6], got[:, :6]) and not torch.equal(got2[:, 6:], got[:, 6:])


def _mixer(name, seed=0):
    """JAX's ``mamba_params`` (dt_bias, A_log and conv_b drawn off their
    inits, so every leaf matters) and a port ``Mamba2`` holding them."""
    jcfg, cfg = jax_smoke_arch(name), get_smoke_arch(name)
    jp = JMB.mamba_params(Ctx("init", jax.random.PRNGKey(seed), jnp.float32), jcfg)
    rng = np.random.default_rng(seed)
    for leaf in ("A_log", "conv_b", "D"):
        jp[leaf] = jnp.asarray(rng.uniform(-0.5, 0.5, jp[leaf].shape), jnp.float32)
    p = mamba2.Mamba2(cfg, dtype=torch.float32)
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jcfg, jp, cfg, p


@pytest.mark.parametrize("name", ARCHS)
def test_mamba_block_equals_jax(name):
    jcfg, jp, cfg, p = _mixer(name)
    x = np.random.default_rng(1).standard_normal((B, S_LEN, cfg.d_model)).astype(np.float32)
    jout, (jh, jtail) = JMB.mamba_block(jp, jnp.asarray(x), jcfg, return_state=True)
    out, (h, tail) = mamba2.mamba_block(p, torch.from_numpy(x), cfg, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), rtol=0, atol=1e-5)
    assert h.dtype == torch.float32
    assert torch.equal(mamba2.mamba_block(p, torch.from_numpy(x), cfg), out)


@pytest.mark.parametrize("name", ARCHS)
def test_mamba_decode_step_equals_jax(name):
    """Eight steps from a random state and conv window: outputs, states and
    windows against JAX's; the port writes both in place."""
    jcfg, jp, cfg, p = _mixer(name, seed=2)
    rng = np.random.default_rng(3)
    s = cfg.ssm
    _, h, conv_dim, _ = mamba2.ssm_dims(cfg)
    st = rng.standard_normal((B, s.n_groups, h // s.n_groups, s.d_state, s.headdim))
    cv = rng.standard_normal((B, s.d_conv - 1, conv_dim))
    jst, jcv = jnp.asarray(st, jnp.float32), jnp.asarray(cv, jnp.float32)
    tst, tcv = torch.from_numpy(st.astype(np.float32)), torch.from_numpy(cv.astype(np.float32))
    for i in range(8):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jst, jcv = JMB.mamba_decode_step(jp, jnp.asarray(x), jcfg, jst, jcv)
        y, st_out, cv_out = mamba2.mamba_decode_step(p, torch.from_numpy(x), cfg, tst, tcv)
        assert st_out is tst and cv_out is tcv
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), rtol=0, atol=1e-5)


def test_decode_continues_mamba_block_state():
    """A block over 16 positions, then decode steps from its returned state
    and conv tail, against the block over all 32 positions."""
    _, _, cfg, p = _mixer("zamba2-7b", seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, 32, cfg.d_model))
                         .astype(np.float32))
    full = mamba2.mamba_block(p, x, cfg)
    _, (st, tail) = mamba2.mamba_block(p, x[:, :16], cfg, return_state=True)
    tail = tail.clone()
    for t in range(16, 32):
        y, _, _ = mamba2.mamba_decode_step(p, x[:, t:t + 1], cfg, st, tail)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=0, atol=1e-5)


def test_uniform_init_draws_dt_bias_in_0_1():
    cfg = get_smoke_arch("mamba2-130m")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    mixer = model.layers[0].mixer
    assert float(mixer.dt_bias.min()) >= 0 and float(mixer.dt_bias.max()) < 1
    assert float(mixer.dt_bias.std()) > 0.1
    assert not mixer.A_log.any() and not mixer.conv_b.any()
    assert bool((mixer.D == 1).all()) and bool((mixer.gate_norm_scale == 1).all())
    assert abs(float(mixer.conv_w.std()) * cfg.ssm.d_conv ** 0.5 - 1) < 0.1


# -- the smoke archs, whole --------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(jax cfg, jax params, port cfg, port model) holding the same weights."""
    name = request.param
    jcfg, cfg = jax_smoke_arch(name), get_smoke_arch(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


def _tokens(cfg, s=S_LEN, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, s)).astype(np.int32)


def test_forward_and_loss_equal_jax(models):
    jcfg, jp, cfg, model = models
    tok = _tokens(cfg)
    labels = np.roll(tok, -1, axis=1)
    jlogits, _ = JM.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    logits, aux = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg)
    assert aux == {} and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    batch = {"tokens": tok, "labels": labels}
    jloss, _ = JM.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, _ = M.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert abs(float(loss) - float(jloss)) < ATOL


def test_prefill_cache_equals_jax(models):
    """Names, shapes and dtypes as JAX's ``forward(collect=True)`` and
    ``cache_shapes``; ``ssm_state`` f32 even in a bf16 model."""
    jcfg, jp, cfg, model = models
    tok = _tokens(cfg, seed=1)
    _, jaux = JM.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg, collect=True)
    _, aux = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg, collect=True)
    jcache, cache = jaux["cache"], aux["cache"]
    assert cache.keys() == jcache.keys() == M.cache_shapes(cfg, B, S_LEN).keys()
    want = {"ssm_state", "conv"} | ({"shared_k", "shared_v"} if cfg.family == "hybrid" else set())
    assert cache.keys() == want
    shapes = M.cache_shapes(cfg, B, S_LEN)
    for name, t in cache.items():
        assert tuple(t.shape) == jcache[name].shape == tuple(shapes[name].shape), name
        assert str(t.dtype).split(".")[1] == str(jcache[name].dtype), name
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=0,
                                   atol=CACHE_ATOL, err_msg=name)
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    bmodel = M.build_params(bf16, "cpu")
    bmodel.load_state_dict({k: v.to(torch.bfloat16) for k, v in model.state_dict().items()})
    _, baux = M.forward(bmodel, {"tokens": torch.from_numpy(tok)}, bf16, collect=True)
    assert baux["cache"]["ssm_state"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for n, t in baux["cache"].items() if n != "ssm_state")
    assert {n: t.dtype for n, t in M.cache_shapes(bf16, 1, 4).items()} == \
        {n: t.dtype for n, t in baux["cache"].items()}


def test_decode_matches_forward(models):
    _, _, cfg, model = models
    tok = torch.from_numpy(_tokens(cfg, seed=2))
    full, _ = M.forward(model, {"tokens": tok}, cfg)
    cache = M.init_cache(cfg, B, S_LEN)
    errs = []
    for i in range(S_LEN):
        lg, cache, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, max(errs)


def test_decode_step_equals_jax(models):
    """Eight steps from an empty cache: logits and every cache tensor."""
    jcfg, jp, cfg, model = models
    tok = _tokens(cfg, s=8, seed=3)
    jcache, cache = JM.init_cache(jcfg, B, 8), M.init_cache(cfg, B, 8)
    for i in range(8):
        jl, jcache, _ = JM.decode_step(jp, jcache, jnp.asarray(tok[:, i:i + 1]), i, jcfg)
        lg, cache, _ = M.decode_step(model, cache, torch.from_numpy(tok[:, i:i + 1]), i, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        assert cache.keys() == jcache.keys()
        for name, t in cache.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=0,
                                       atol=CACHE_ATOL, err_msg=name)
    assert cache["ssm_state"].dtype == torch.float32


def test_prefill_cache_feeds_decode(models):
    """A 16-token prefill, padded by the launcher, then 16 decode steps
    against the forward's positions."""
    _, _, cfg, model = models
    tok = torch.from_numpy(_tokens(cfg, seed=4))
    full, _ = M.forward(model, {"tokens": tok}, cfg)
    half = S_LEN // 2
    _, pre = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, {"tokens": tok[:, :half]})
    cache = serve_cli.pad_cache(pre, S_LEN)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in M.cache_shapes(cfg, B, S_LEN).items()}
    errs = []
    for i in range(half, S_LEN):
        lg, cache, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, max(errs)


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_equals_jax(name):
    cfg, jcfg = get_arch(name), jax_arch(name)
    for kw in ({}, {"include_embed": True}, {"active_only": True}):
        assert M.param_count(cfg, **kw) == JM.param_count(jcfg, **kw), kw
    want = {"mamba2-130m": 167_598_528, "zamba2-7b": 6_788_341_584}[name]
    assert M.param_count(cfg, include_embed=True) == want
    if name == "zamba2-7b":      # the shared block once, at 24 of 81 layers too
        cut = dataclasses.replace(cfg, n_layers=24)
        assert M.param_count(cut, include_embed=True) == 2_317_406_592 == \
            JM.param_count(dataclasses.replace(jcfg, n_layers=24), include_embed=True)


@pytest.mark.parametrize("name", ARCHS)
def test_params_round_trip(name):
    cfg, jcfg = get_smoke_arch(name), jax_smoke_arch(name)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    sd = params_from_jax(cfg, tree)
    model = M.build_params(cfg, "meta")
    assert sd.keys() == model.state_dict().keys()
    assert sd["layers.0.mixer.in_proj"].shape == tree["layers"]["in_proj"].shape[1:]
    assert ("shared_attn" in tree) == (cfg.family == "hybrid") == \
        ("shared_attn.attn.wq" in sd)
    back = params_to_jax(cfg, sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_shared_block_is_one_module_applied_every_period(monkeypatch):
    cfg = get_smoke_arch("zamba2-7b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters() if n.startswith("shared_attn.")]
    assert len(names) == 9 and all(not n.startswith("layers.") for n in names)
    calls = []
    real = M._dense_block

    def counting(block, *args, **kw):
        calls.append(block is model.shared_attn)
        return real(block, *args, **kw)
    monkeypatch.setattr(M, "_dense_block", counting)
    M.forward(model, {"tokens": torch.zeros((1, 16), dtype=torch.int32)}, cfg)
    assert calls == [True] * (cfg.n_layers // cfg.hybrid_attn_every)


# -- launch/serve: the prompt cache padded on sequence axes only -------------

@pytest.mark.parametrize("name", ARCHS)
def test_pad_cache_grows_sequence_caches_only(name):
    cfg = get_smoke_arch(name)
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(cfg, s=16, seed=5))
    _, pre = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, {"tokens": tok})
    padded = serve_cli.pad_cache(pre, 40)
    shapes = M.cache_shapes(cfg, B, 40)
    for n, t in padded.items():
        assert tuple(t.shape) == tuple(shapes[n].shape) and t.dtype == shapes[n].dtype, n
        if n in serve_cli.SEQ_CACHES:
            assert torch.equal(t[:, :, :16], pre[n]) and not t[:, :, 16:].any()
        else:
            assert torch.equal(t, pre[n])
    assert set(padded) - set(serve_cli.SEQ_CACHES) == {"ssm_state", "conv"}


@pytest.mark.parametrize("name", ARCHS)
def test_run_serve_equals_a_decode_from_a_cache_built_at_full_length(name):
    """run_serve's tokens against a greedy loop whose cache is
    ``init_cache`` at max_len with the prompt's entries copied in (the
    sequence caches' first positions, the SSM state and conv window whole):
    bitwise, the sketch too."""
    cfg = dataclasses.replace(get_smoke_arch(name), sketch=dataclasses.replace(
        get_smoke_arch(name).sketch, kernel="sorted"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    prompt_len, gen = 32, 12
    out = serve_cli.run_serve(cfg, batch=B, prompt_len=prompt_len, gen=gen, report_every=4,
                              device="cpu", model=model)
    plan = ShardingPlan(cfg)
    last, pre = S.make_prefill_step(cfg, plan)(model, {"tokens": torch.from_numpy(out["prompt"])})
    cache = M.init_cache(cfg, B, prompt_len + gen)
    for n, t in pre.items():
        if n in serve_cli.SEQ_CACHES:
            cache[n][:, :, :prompt_len] = t
        else:
            cache[n].copy_(t)
    serve = S.make_serve_step(cfg, plan, device="cpu")
    sketch = SK.token_runtime(cfg.sketch, 1, chunk=B, device="cpu").init()
    tokens, emitted = last.argmax(-1).to(torch.int32)[:, None], []
    for i in range(gen):
        nxt, cache, sketch = serve(model, cache, tokens, prompt_len + i, sketch)
        emitted.append(nxt)
        tokens = nxt[:, None]
    np.testing.assert_array_equal(out["tokens"], torch.stack(emitted, 1).numpy())
    for a, b in zip(state_to_numpy(out["sketch"]), state_to_numpy(sketch)):
        np.testing.assert_array_equal(a, b)
    assert len(out["reports"]) == 3 and out["reports"][-1]["n"] == B * gen


def test_serve_cli_defaults_to_mamba2(capsys):
    assert serve_cli.main(["--device", "cpu", "--smoke", "--batch", "2", "--prompt-len", "16",
                           "--gen", "4", "--report-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "[serve.hot_tokens] step=4" in out and "[serve.decode.done]" in out


def test_ssm_modules_import_no_jax():
    code = ("import sys, repro_torch.models.mamba2, repro_torch.models.model, "
            "repro_torch.launch.serve, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
