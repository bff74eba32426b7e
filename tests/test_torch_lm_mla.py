"""repro_torch.models.mla and the MLA family (minicpm3-4b) against repro.

minicpm3-4b's smoke arch (2 layers, d 128, 4 heads, q_lora 64, kv_lora 32,
nope 16, rope 16, v 32; f32), with the JAX package's ``init_params(PRNGKey(0))``
carried over by ``models/convert.py`` (whose round trip is exact).
Tolerances:

  * ``mla_prefill``, ``mla_decode``, ``mla_new_cache_entry``, the forward's
    logits, loss and prefill cache against JAX: 2e-5 absolute
    (``test_torch_lm_model.ATOL``): the same f32 operations in the same
    order, only the summation order inside each product differs (XLA
    against ATen).
  * decode against forward, within the port: JAX's own 5e-4
    (``tests/test_models_smoke.py``): the prefill expands the latent and
    runs the blockwise softmax, the decode absorbs ``wuk``/``wuv`` and
    scores against the latent, so the sums run in other orders.
  * ``launch/serve.run_serve``: the tokens and the token sketch bitwise a
    run whose cache is built at full length from the start (the prefill
    cache's sequence axis, 2, padded for every cache layout).
"""
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
from repro.models import mla as JMLA
from repro.models import model as JM
from repro_torch.configs.registry import get_arch, get_smoke_arch
from repro_torch.engine import state_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mla
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK
from repro_torch.train import steps as S

torch.set_num_threads(1)
ARCH = "minicpm3-4b"
B, S_LEN = 2, 32
ATOL = 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _layer0(jp):
    return {name: leaf[0] for name, leaf in jp["layers"].items()}


def _x(cfg, s, seed=0):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _tokens(cfg, s=S_LEN, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, s)).astype(np.int32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def test_mla_module_leaves_equal_jax(models):
    jcfg, jp, cfg, model = models
    blk = model.layers[0].attn
    assert isinstance(blk, mla.MLA)
    for name, leaf in _layer0(jp).items():
        if name.startswith(("attn_norm", "mlp_norm", "w_")):
            continue
        assert torch.equal(getattr(blk, name), torch.from_numpy(np.array(leaf))), name
    fresh = M.init_params(cfg, torch.Generator().manual_seed(0)).layers[0].attn
    assert bool((fresh.q_norm_scale == 1).all()) and bool((fresh.kv_norm_scale == 1).all())
    hv = cfg.n_heads * cfg.mla.v_head_dim
    want = hv ** -0.5 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(fresh.wo.std()) / want - 1) < 0.1


@pytest.mark.parametrize("schedule", ["masked", "band"])
def test_mla_prefill_equals_jax(models, schedule):
    jcfg, jp, cfg, model = models
    x = _x(cfg, S_LEN)
    pos = np.broadcast_to(np.arange(S_LEN)[None], (B, S_LEN)).astype(np.int32)
    jout, (jc, jr) = JMLA.mla_prefill(_layer0(jp), jnp.asarray(x), jcfg, jnp.asarray(pos),
                                      block_q=8, block_kv=8, schedule=schedule)
    out, (c, r) = mla.mla_prefill(model.layers[0].attn, torch.from_numpy(x), cfg,
                                  torch.from_numpy(pos), block_q=8, block_kv=8,
                                  schedule=schedule)
    assert out.shape == (B, S_LEN, cfg.d_model)
    assert c.shape == (B, S_LEN, cfg.mla.kv_lora_rank)
    assert r.shape == (B, S_LEN, cfg.mla.qk_rope_head_dim)
    _close(out, jout)
    _close(c, jc)
    _close(r, jr)


@pytest.mark.parametrize("position", [0, 13, S_LEN - 1])
def test_mla_decode_and_cache_entry_equal_jax(models, position):
    jcfg, jp, cfg, model = models
    rng = np.random.default_rng(position)
    x = _x(cfg, 1, seed=position)
    cache = {"c_kv": rng.standard_normal((B, S_LEN, cfg.mla.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((B, S_LEN, cfg.mla.qk_rope_head_dim))
             .astype(np.float32)}
    p, jpl = model.layers[0].attn, _layer0(jp)
    jout = JMLA.mla_decode(jpl, jnp.asarray(x), jcfg,
                           {k: jnp.asarray(v) for k, v in cache.items()}, position)
    out = mla.mla_decode(p, torch.from_numpy(x), cfg,
                         {k: torch.from_numpy(v) for k, v in cache.items()}, position)
    assert out.shape == (B, 1, cfg.d_model)
    _close(out, jout)
    jc, jr = JMLA.mla_new_cache_entry(jpl, jnp.asarray(x), jcfg, position)
    c, r = mla.mla_new_cache_entry(p, torch.from_numpy(x), cfg, position)
    _close(c, jc)
    _close(r, jr)


def test_forward_loss_and_cache_equal_jax(models):
    jcfg, jp, cfg, model = models
    tok = _tokens(cfg)
    labels = np.roll(tok, -1, axis=1)
    jlogits, jaux = JM.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg, collect=True)
    logits, aux = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg, collect=True)
    assert logits.shape == (B, S_LEN, cfg.vocab)
    _close(logits, jlogits)
    assert aux["cache"].keys() == jaux["cache"].keys() == {"c_kv", "k_rope"}
    for name in ("c_kv", "k_rope"):
        _close(aux["cache"][name], jaux["cache"][name])
    band, _ = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg, schedule="band")
    torch.testing.assert_close(band, logits, rtol=0, atol=ATOL)
    jloss, _ = JM.loss_fn(jp, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)},
                          jcfg)
    loss, laux = M.loss_fn(model, {"tokens": torch.from_numpy(tok),
                                   "labels": torch.from_numpy(labels)}, cfg)
    assert abs(float(loss) - float(jloss)) < ATOL and "aux_loss" not in laux


def test_decode_matches_forward(models):
    _, _, cfg, model = models
    tok = torch.from_numpy(_tokens(cfg, seed=1))
    full, _ = M.forward(model, {"tokens": tok}, cfg)
    cache = M.init_cache(cfg, B, S_LEN)
    errs = []
    for i in range(S_LEN):
        lg, cache, aux = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, max(errs)
    assert aux == {}


def test_decode_step_equals_jax(models):
    """Eight decode steps from an empty cache: logits within ATOL of JAX's
    ``decode_step`` and the latent cache too."""
    jcfg, jp, cfg, model = models
    tok = _tokens(cfg, s=8, seed=2)
    jcache, cache = JM.init_cache(jcfg, B, 8), M.init_cache(cfg, B, 8)
    for i in range(8):
        jl, jcache, _ = JM.decode_step(jp, jcache, jnp.asarray(tok[:, i:i + 1]), i, jcfg)
        lg, cache, _ = M.decode_step(model, cache, torch.from_numpy(tok[:, i:i + 1]), i, cfg)
        _close(lg, jl)
    for name in ("c_kv", "k_rope"):
        _close(cache[name], jcache[name])


def test_prefill_cache_feeds_decode(models):
    _, _, cfg, model = models
    tok = torch.from_numpy(_tokens(cfg, seed=3))
    full, _ = M.forward(model, {"tokens": tok}, cfg)
    half = S_LEN // 2
    _, pre = S.make_prefill_step(cfg, ShardingPlan(cfg))(model, {"tokens": tok[:, :half]})
    cache = {k: serve_cli.pad_seq(v, S_LEN) for k, v in pre.items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in M.cache_shapes(cfg, B, S_LEN).items()}
    for i in range(half, S_LEN):
        lg, cache, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        err = float((lg[:, 0] - full[:, i]).abs().max())
        assert err < 5e-4, (i, err)


@pytest.mark.parametrize("smoke", [False, True])
def test_cache_shapes_equal_jax(smoke):
    cfg, jcfg = ((get_smoke_arch(ARCH), jax_smoke_arch(ARCH)) if smoke
                 else (get_arch(ARCH), jax_arch(ARCH)))
    ours, theirs = M.cache_shapes(cfg, 4, 96), JM.cache_shapes(jcfg, 4, 96)
    assert ours.keys() == theirs.keys() == {"c_kv", "k_rope"}
    for k in ours:
        assert ours[k].device.type == "meta"
        assert tuple(ours[k].shape) == theirs[k].shape
        assert str(ours[k].dtype).removeprefix("torch.") == str(theirs[k].dtype)


def test_params_round_trip_and_bf16_bits():
    for dtype in ("float32", "bfloat16"):
        kw = dict(param_dtype=dtype, compute_dtype=dtype)
        cfg, jcfg = get_smoke_arch(ARCH, **kw), jax_smoke_arch(ARCH, **kw)
        tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
        sd = params_from_jax(cfg, tree)
        assert sd.keys() == M.build_params(cfg, "meta").state_dict().keys()
        back = params_to_jax(cfg, sd)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_run_serve_pads_the_latent_cache():
    """``run_serve`` pads the prefill's latent cache (L, B, S, r) on its
    sequence axis: its tokens and sketch equal those of a decode loop whose
    cache is built at ``max_len`` from the start and given the prefill's
    lines."""
    cfg = get_smoke_arch(ARCH)
    b, prompt_len, gen = 2, 16, 12
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = serve_cli.run_serve(cfg, batch=b, prompt_len=prompt_len, gen=gen, report_every=4,
                              k_majority=8, device="cpu", model=model)
    plan = ShardingPlan(cfg)
    last, pre = S.make_prefill_step(cfg, plan)(model, {"tokens": torch.from_numpy(out["prompt"])})
    cache = M.init_cache(cfg, b, prompt_len + gen)
    for name, c in pre.items():
        cache[name][:, :, :prompt_len] = c
    serve = S.make_serve_step(cfg, plan, device="cpu")
    sketch = SK.token_runtime(cfg.sketch, 1, chunk=b, device="cpu").init()
    tok, emitted = last.argmax(-1).to(torch.int32)[:, None], []
    for i in range(gen):
        nxt, cache, sketch = serve(model, cache, tok, prompt_len + i, sketch)
        emitted.append(nxt)
        tok = nxt[:, None]
    np.testing.assert_array_equal(out["tokens"], torch.stack(emitted, 1).numpy())
    for x, y in zip(state_to_numpy(out["sketch"]), state_to_numpy(sketch)):
        np.testing.assert_array_equal(x, y)


def test_pad_seq_pads_axis_2_of_every_layout():
    for shape in ((3, 2, 5, 4, 8), (3, 2, 5, 7)):
        c = torch.randn(shape)
        p = serve_cli.pad_seq(c, 9)
        assert p.shape == shape[:2] + (9,) + shape[3:]
        assert torch.equal(p[:, :, :5], c) and not p[:, :, 5:].any()


def test_new_modules_import_no_jax():
    code = ("import sys, repro_torch.models.mla, repro_torch.models.moe, "
            "repro_torch.models.model, repro_torch.launch.train, repro_torch.train.steps\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
