"""repro_torch.models.moe and the MoE family (qwen3-moe-30b-a3b,
mixtral-8x7b) against repro, on the CPU at f32.

Integers are held bitwise: ``_dispatch_one`` on integer expert ids (drops
included), the router's top-k on tied probabilities (lower index first, as
``lax.top_k``), ``expert_counts`` and the expert sketch. The router's
logits of XLA and ATen differ by a few f32 ulps, so before counts are
compared bitwise, every top-k the port took in that run is asserted to
have a gap of more than ``MARGIN`` between its k-th and (k+1)-th
probability (``_Margins``): there the two packages pick the same experts.
Floats:

  * ``moe_layer``'s y against JAX's within 1e-5 absolute (outputs of order
    1; the same f32 products, summed in another order, and the k
    contributions of a token added in top-k order here, in expert order by
    JAX's scatter-add), its ``aux_loss`` within 1e-5 relative;
  * a dense reference (every token through its top-k experts, computed
    expert by expert) at capacity factor 8 within 1e-4, as JAX's
    ``tests/test_moe.py``;
  * the smoke archs' logits within 2e-5 and loss within 2e-5
    (``test_torch_lm_model.ATOL``);
  * three train steps against JAX's: loss 1e-5 relative, ``moe_aux_loss``
    1e-5 relative, the token and expert sketches bitwise after every step.
    The learning rate peaks at 1e-6: Adam moves a parameter by about ±lr
    whatever its gradient's size, so a gradient near 0 whose sign differs
    between the packages moves it by up to 2·lr a step (the sign hazard of
    ``test_torch_lm_train.py``); at 1e-6 the params stay within 4·10^-6 of
    each other (asserted) and the router's probabilities within f32 noise,
    so ``MARGIN`` still decides the routing;
  * every remat policy gives the same loss, grads and counts, bit for bit,
    and counts every assignment once;
  * either package's trainer resumes the other's mixtral checkpoint at
    ``--lr 0``: the weights stay those each run started from, so the
    expert sketch of steps 5–8 depends on routing that both packages
    compute from the same weights, and the step-8 sketches are bitwise the
    writing package's uninterrupted run.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models.layers import Ctx
from repro.optim import adamw as jadamw
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro.train import steps as JS
from repro_torch.configs import base
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import state_to_numpy
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.optim import adamw
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK
from repro_torch.train import steps as S

torch.set_num_threads(1)
MOE_ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
B, S_LEN = 2, 32
ATOL = 2e-5
MARGIN = 1e-5          # f32 router probabilities of XLA and ATen differ by ~1e-7


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


class _Margins:
    """Wraps ``moe.top_k`` and records, for every call, the smallest gap
    between a token's k-th and (k+1)-th probability."""

    def __init__(self, monkeypatch):
        self.gaps: list[float] = []
        real = moe.top_k

        def recording(probs, k):
            if probs.shape[-1] > k:
                s = torch.sort(probs.detach(), dim=-1, descending=True).values
                self.gaps.append(float((s[..., k - 1] - s[..., k]).min()))
            return real(probs, k)
        monkeypatch.setattr(moe, "top_k", recording)

    def assert_above(self, margin):
        assert self.gaps, "no top-k was taken"
        assert min(self.gaps) > margin, (min(self.gaps), margin)


def _layer_cfgs(cf=1.25, top_k=2, e=4, norm=False):
    """The port's and JAX's configs of one MoE layer (JAX's test_moe._cfg)."""
    def one(b):
        return b.ArchConfig(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
                            n_kv_heads=4, d_ff=64, vocab=128, param_dtype="float32",
                            compute_dtype="float32",
                            moe=b.MoEConfig(n_experts=e, top_k=top_k, d_ff_expert=16,
                                            capacity_factor=cf, router_norm_topk=norm))
    return one(base), one(jbase)


def _layer(cfg, jcfg, seed):
    """JAX's ``moe_params`` and a port ``MoE`` holding the same weights."""
    jp = JMOE.moe_params(Ctx("init", jax.random.PRNGKey(seed), jnp.float32), jcfg)
    p = moe.MoE(cfg, dtype=torch.float32)
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    return jp, p


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s,k,e,cap", [(16, 2, 4, 9), (16, 2, 4, 3), (32, 8, 16, 1),
                                       (7, 3, 5, 2), (8, 2, 8, 1)])
def test_dispatch_one_equals_jax(s, k, e, cap):
    """Bitwise on integer expert ids, ids repeated within a token and
    assignments dropped beyond ``cap`` included."""
    rng = np.random.default_rng(s * 100 + cap)
    top_e = rng.integers(0, e, (s, k)).astype(np.int32)
    xt = _x((s, 6), seed=cap)
    want = JMOE._dispatch_one(jnp.asarray(xt), jnp.asarray(top_e), cap, e)
    got = moe._dispatch_one(torch.from_numpy(xt), torch.from_numpy(top_e), cap, e)
    names = ("buf", "slot", "token_of", "keep", "order", "counts")
    for name, a, b in zip(names, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(got[3].sum()) < s * k or cap * e >= s * k      # drops where cap binds


@pytest.mark.parametrize("cf,top_k,e,norm", [(8.0, 2, 4, False), (1.25, 2, 8, False),
                                             (0.1, 2, 4, False), (1.25, 4, 16, True)])
def test_moe_layer_equals_jax(cf, top_k, e, norm, monkeypatch):
    cfg, jcfg = _layer_cfgs(cf, top_k, e, norm)
    jp, p = _layer(cfg, jcfg, seed=e + top_k)
    x = _x((2, 16, 32), seed=e)
    margins = _Margins(monkeypatch)
    jy, jaux = JMOE.moe_layer(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_layer(p, torch.from_numpy(x), cfg)
    margins.assert_above(MARGIN)
    assert aux["expert_counts"].dtype == torch.int32
    np.testing.assert_array_equal(aux["expert_counts"].numpy(), np.asarray(jaux["expert_counts"]))
    assert int(aux["expert_counts"].sum()) == 2 * 16 * top_k
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(aux["aux_loss"]) / float(jaux["aux_loss"]) - 1) <= 1e-5
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) < 1e3


def _dense_reference(p: moe.MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Every token through its top-k experts, computed densely."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ p.router, -1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    outs = torch.stack([(torch.nn.functional.silu(xt @ p.w_gate[i]) * (xt @ p.w_up[i]))
                        @ p.w_down[i] for i in range(m.n_experts)], 1)    # (T, E, D)
    y = torch.zeros_like(xt)
    for j in range(m.top_k):
        y = y + top_p[:, j:j + 1] * outs[torch.arange(xt.shape[0]), top_e[:, j]]
    return y.reshape(b, s, d)


def test_moe_matches_dense_reference_at_capacity_8():
    cfg, jcfg = _layer_cfgs(cf=8.0)
    _, p = _layer(cfg, jcfg, seed=0)
    x = torch.from_numpy(_x((2, 16, 32), seed=1))
    y, aux = moe.moe_layer(p, x, cfg)
    torch.testing.assert_close(y, _dense_reference(p, x, cfg), rtol=1e-4, atol=1e-4)
    assert int(aux["expert_counts"].sum()) == 2 * 16 * cfg.moe.top_k


def test_capacity_dropping_is_graceful():
    cfg, jcfg = _layer_cfgs(cf=0.1)
    _, p = _layer(cfg, jcfg, seed=1)
    x = torch.from_numpy(_x((2, 32, 32), seed=2))
    y, aux = moe.moe_layer(p, x, cfg)
    slot, _, keep, _, counts = moe.dispatch(
        moe.top_k(torch.softmax(x @ p.router, -1), 2)[1], moe.capacity(cfg, 32), 4)
    assert int(keep.sum()) < keep.numel()              # cap 2 of 64 a row: drops
    assert torch.equal(counts.sum(0, dtype=torch.int32), aux["expert_counts"])
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) < 1e3


def test_top_k_keeps_lower_index_on_ties():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1], [0.2, 0.2, 0.5, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # a zero router ties every expert: each token takes experts 0..k-1
    cfg, jcfg = _layer_cfgs(cf=8.0, top_k=2, e=8)
    jp, p = _layer(cfg, jcfg, seed=2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    with torch.no_grad():
        p.router.zero_()
    x = _x((2, 8, 32), seed=3)
    _, jaux = JMOE.moe_layer(jp, jnp.asarray(x), jcfg)
    _, aux = moe.moe_layer(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(aux["expert_counts"].numpy(), np.asarray(jaux["expert_counts"]))
    assert aux["expert_counts"].tolist() == [16, 16, 0, 0, 0, 0, 0, 0]


def test_expert_counts_feed_sketch():
    cfg, jcfg = _layer_cfgs(cf=8.0)
    _, p = _layer(cfg, jcfg, seed=2)
    _, aux = moe.moe_layer(p, torch.from_numpy(_x((1, 64, 32), seed=4)), cfg)
    sk_cfg = base.SketchConfig(expert_counters=8)
    engine = SK.expert_engine(sk_cfg, device="cpu")
    sk = SK.update_expert_sketch(engine, SK.init_expert_sketch(sk_cfg, device="cpu"),
                                 aux["expert_counts"])
    items, counts = sk.items[0].numpy(), sk.counts[0].numpy()
    for e, c in enumerate(aux["expert_counts"].tolist()):
        if c > 0:
            assert e in items and int(counts[items == e][0]) == c


def _models(name):
    jcfg, cfg = jax_smoke_arch(name), get_smoke_arch(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_forward_loss_and_counts_equal_jax(name, monkeypatch):
    jcfg, jp, cfg, model = _models(name)
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    margins = _Margins(monkeypatch)
    jlogits, jaux = JM.forward(jp, {"tokens": jnp.asarray(tok)}, jcfg)
    logits, aux = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg)
    margins.assert_above(MARGIN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(aux["expert_counts"].numpy(), np.asarray(jaux["expert_counts"]))
    assert int(aux["expert_counts"].sum()) == B * S_LEN * cfg.moe.top_k * cfg.n_layers
    assert abs(float(aux["aux_loss"]) / float(jaux["aux_loss"]) - 1) <= 1e-5
    batch = {"tokens": tok, "labels": labels}
    jloss, _ = JM.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, laux = M.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert abs(float(loss) - float(jloss)) < ATOL
    assert float(loss) > float(M.cross_entropy(logits, torch.from_numpy(labels)))
    _, caux = M.forward(model, {"tokens": torch.from_numpy(tok)}, cfg, collect=True)
    assert caux["cache"].keys() == {"k", "v"}
    assert torch.equal(caux["expert_counts"], aux["expert_counts"])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_step_equals_jax(name, monkeypatch):
    """Eight decode steps from an empty cache: logits within ATOL of JAX's,
    expert counts bitwise JAX's and B·k·L a step (decode never drops:
    cap ≥ 1 and a token's k experts are distinct)."""
    jcfg, jp, cfg, model = _models(name)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, 8)).astype(np.int32)
    jcache, cache = JM.init_cache(jcfg, B, 8), M.init_cache(cfg, B, 8)
    margins = _Margins(monkeypatch)
    for i in range(8):
        jl, jcache, jaux = JM.decode_step(jp, jcache, jnp.asarray(tok[:, i:i + 1]), i, jcfg)
        lg, cache, aux = M.decode_step(model, cache, torch.from_numpy(tok[:, i:i + 1]), i, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(aux["expert_counts"].numpy(),
                                      np.asarray(jaux["expert_counts"]))
        assert int(aux["expert_counts"].sum()) == B * cfg.moe.top_k * cfg.n_layers
    margins.assert_above(MARGIN)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_a_forward_that_drops_nothing(name):
    """A decode step never drops (cap ≥ 1, a token's k experts distinct), a
    72-token forward at the configured capacity does; at capacity factor
    E/k the forward drops nothing either and computes what the decode steps
    compute: within JAX's own decode-vs-forward 5e-4
    (``tests/test_models_smoke.py``)."""
    cfg = get_smoke_arch(name)
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, 72))
                           .astype(np.int32))
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    assert moe.capacity(no_drop, 72) > 72 and moe.capacity(cfg, 72) < 72
    full, _ = M.forward(model, {"tokens": tok}, no_drop)
    cache = M.init_cache(cfg, B, 72)
    errs = []
    for i in range(72):
        lg, cache, _ = M.decode_step(model, cache, tok[:, i:i + 1], i, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, max(errs)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_params_round_trip(name):
    cfg, jcfg = get_smoke_arch(name), jax_smoke_arch(name)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    sd = params_from_jax(cfg, tree)
    model = M.build_params(cfg, "meta")
    assert sd.keys() == model.state_dict().keys()
    assert sd["layers.0.moe.w_gate"].shape == (cfg.moe.n_experts, cfg.d_model,
                                               cfg.moe.d_ff_expert)
    back = params_to_jax(cfg, sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_train_steps_feed_the_expert_sketch_as_jax(monkeypatch):
    """Three train steps of qwen3-moe's smoke arch (router_norm_topk) against
    JAX's jitted ``make_train_step`` from the same weights and batches."""
    name = "qwen3-moe-30b-a3b"

    def pin(c):
        return dataclasses.replace(c, sketch=dataclasses.replace(c.sketch, kernel="sorted"))
    cfg, jcfg = pin(get_smoke_arch(name)), pin(jax_smoke_arch(name))
    jplan, plan = JShardingPlan(jcfg, None), ShardingPlan(cfg)
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0), jplan)
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params)))
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), plan, device="cpu",
                               model=model)
    jstep = jax.jit(JS.make_train_step(jcfg, jplan, lr_fn=jadamw.cosine_schedule(1e-6, 2, 10)))
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(1e-6, 2, 10), device="cpu")
    data = TokenStream(cfg.vocab, 4, 64)
    margins = _Margins(monkeypatch)
    per_step = 4 * 64 * cfg.moe.top_k * cfg.n_layers
    lr_sum = 0.0
    for i in range(3):
        host = data.next()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in host.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
        lr_sum += float(m["lr"])
        margins.assert_above(MARGIN)
        tree = S.checkpoint_tree(cfg, state)
        for a, b in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(tree.params)):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 2 * lr_sum + 1e-6
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= 1e-5
        assert "moe_aux_loss" in m and "moe_aux_loss" in jm
        assert abs(float(m["moe_aux_loss"]) / float(jm["moe_aux_loss"]) - 1) <= 1e-5
        for a, b in zip(jax.tree.leaves(jstate.expert_sketch),
                        state_to_numpy(state.expert_sketch)):
            np.testing.assert_array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(jstate.token_sketch),
                        state_to_numpy(state.token_sketch)):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert int(state.expert_sketch.counts.sum()) == (i + 1) * per_step
        assert int(state.expert_sketch.n.sum()) == (i + 1) * per_step


def _loss_grads_counts(model, cfg, batch):
    model.zero_grad(set_to_none=True)
    loss, aux = M.loss_fn(model, batch, cfg)
    loss.backward()
    return (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
            aux["expert_counts"], aux["aux_loss"].detach())


@pytest.mark.parametrize("remat", ["full", "dots", "nested:2", "nested"])
def test_remat_policies_give_the_same_loss_grads_and_counts(remat):
    cfg = get_smoke_arch("mixtral-8x7b", n_layers=4)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    host = TokenStream(cfg.vocab, 2, 64).next()
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    loss0, g0, c0, a0 = _loss_grads_counts(model, dataclasses.replace(cfg, remat="none"), batch)
    loss, g, c, a = _loss_grads_counts(model, dataclasses.replace(cfg, remat=remat), batch)
    assert torch.equal(loss, loss0) and torch.equal(a, a0)
    assert torch.equal(c, c0) and int(c.sum()) == 2 * 64 * cfg.moe.top_k * cfg.n_layers
    assert g0["layers.0.moe.router"].abs().max() > 0     # the aux loss reaches the router
    for name in g0:
        assert torch.equal(g[name], g0[name]), name


# -- launch/train: crash and resume, within the port and across packages -----

ARCH = "mixtral-8x7b"
CLI = ["--arch", ARCH, "--smoke", "--steps", "8", "--batch", "2", "--seq", "64",
       "--ckpt-every", "4", "--merge-every", "4", "--log-every", "4", "--lr", "0"]


def _leaves(ckpt: Path, step: int) -> dict:
    d = ckpt / ARCH / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    arrays = np.load(d / "arrays.npz")
    return {p: arrays[f"leaf_{i}"] for i, p in enumerate(manifest["paths"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's uninterrupted run, the port's crash/resume, and each
    package resuming the other's step-4 checkpoint; the smallest gap any of
    the port's top-k took on the way."""
    root = tmp_path_factory.mktemp("train_moe")
    gaps = []
    real = moe.top_k

    def recording(probs, k):
        s = torch.sort(probs.detach(), dim=-1, descending=True).values
        gaps.append(float((s[..., k - 1] - s[..., k]).min()))
        return real(probs, k)
    mp = pytest.MonkeyPatch()
    mp.setattr(moe, "top_k", recording)
    cpu = ("--device", "cpu")
    try:
        out = {"root": root,
               "port": train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port")])}
        with pytest.raises(SystemExit) as crash:
            train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_crash"),
                            "--crash-at", "4"])
        out["crash_code"] = crash.value.code
        out["port_resumed"] = train_cli.main([*cpu, *CLI, "--ckpt-dir",
                                              str(root / "port_crash")])
        jtrain.main([*CLI, "--ckpt-dir", str(root / "jax")])
        with pytest.raises(SystemExit):
            jtrain.main([*CLI, "--ckpt-dir", str(root / "jax_then_port"), "--crash-at", "4"])
        out["jax_then_port"] = train_cli.main([*cpu, *CLI, "--ckpt-dir",
                                               str(root / "jax_then_port")])
        with pytest.raises(SystemExit):
            train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_then_jax"),
                            "--crash-at", "4"])
        jtrain.main([*CLI, "--ckpt-dir", str(root / "port_then_jax")])
    finally:
        mp.undo()
    out["min_gap"] = min(gaps)
    return out


def _assert_sketches_equal(a: dict, b: dict):
    keys = [p for p in a if p.startswith((".token_sketch", ".expert_sketch", ".opt.count"))]
    assert len(keys) == 13       # 6 leaves a SketchState, and the count
    for p in keys:
        np.testing.assert_array_equal(a[p], b[p], err_msg=p)


def test_main_crash_and_resume_reproduces_the_run(runs):
    whole, resumed = runs["port"], runs["port_resumed"]
    assert runs["crash_code"] == 42 and resumed["start"] == 4
    np.testing.assert_array_equal(resumed["tokens"], whole["tokens"][4:])
    assert resumed["losses"] == whole["losses"][4:]
    for name in ("token_sketch", "expert_sketch"):
        for a, b in zip(state_to_numpy(getattr(resumed["state"], name)),
                        state_to_numpy(getattr(whole["state"], name))):
            np.testing.assert_array_equal(a, b)
    cfg = get_smoke_arch(ARCH)
    assert int(whole["state"].expert_sketch.n.sum()) == \
        8 * 2 * 64 * cfg.moe.top_k * cfg.n_layers
    root = runs["root"]
    _assert_sketches_equal(_leaves(root / "port_crash", 8), _leaves(root / "port", 8))


@pytest.mark.parametrize("case,ref", [("jax_then_port", "jax"), ("port_then_jax", "port")])
def test_either_package_resumes_the_others_checkpoint(runs, case, ref):
    """At lr 0 the params of every step are the writer's initial weights,
    so steps 5–8 route as the writer's own run does wherever the port's
    top-k gaps exceed ``MARGIN``: the step-8 sketches (token and expert)
    and params are the writer's uninterrupted run's."""
    assert runs["min_gap"] > MARGIN, runs["min_gap"]
    root = runs["root"]
    got, want = _leaves(root / case, 8), _leaves(root / ref, 8)
    assert got.keys() == want.keys()
    _assert_sketches_equal(got, want)
    params = sorted(p for p in got if p.startswith((".params", ".opt.master")))
    assert any("router" in p for p in params)
    for p in params:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    if case == "jax_then_port":
        assert runs["jax_then_port"]["start"] == 4
