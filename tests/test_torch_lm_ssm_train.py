"""The LM training path of the SSM (mamba2-130m) and hybrid (zamba2-7b)
families against the JAX package's, on the CPU at f32 (the smoke archs,
with the JAX package's ``init_params(PRNGKey(0))`` carried over by
``models/convert.py``):

  * two train steps against JAX's jitted ``make_train_step`` under each
    remat policy (none, full, dots, nested:2; the hybrid family maps
    nested to a checkpoint a layer, as JAX's ``lax.scan(_remat(body))``):
    loss within 1e-5 and grad norm within 1e-4 relative (the same f32
    operations, summed in other orders by XLA and ATen), params within the
    sign bound of ``test_torch_lm_train.py`` (2·Σlr + 1e-5, fewer than 0.1%
    off by more than 1e-5), the token sketch bitwise after every step. The
    learning rate peaks at 1e-3: at 1e-2 a first-step sign flip (Adam moves
    a parameter by ±lr whatever its gradient's size) moves a few out_proj
    entries by 2·lr, which shifts every second-step gradient of the smoke
    archs by ~1e-3 relative and so ~6% of the params by more than 1e-5;
    the loss and grad norm still agree within their tolerances there;
  * within the port, every remat policy gives the same loss and grads bit
    for bit, and the shared block's gradient is the sum over its
    applications;
  * ``launch/train.main`` on zamba2-7b's smoke arch, and on mamba2-130m's
    with ``--crash-at 4`` then resumed: the batches, sketch, losses and
    params of the uninterrupted run bit for bit; and either package's
    trainer resumes the other's step-4 checkpoint (the step-8 sketch
    bitwise the resuming package's own run, params within the sign bound
    of the writing package's).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro.train import steps as JS
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import state_to_numpy
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import steps as S

torch.set_num_threads(1)
ARCHS = ["mamba2-130m", "zamba2-7b"]


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


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


@pytest.mark.parametrize("remat", ["none", "full", "dots", "nested:2"])
@pytest.mark.parametrize("name", ARCHS)
def test_train_steps_equal_jax(name, remat):
    cfg = _pin(get_smoke_arch(name), remat=remat)
    jcfg = _pin(jax_smoke_arch(name), remat=remat)
    jplan, plan = JShardingPlan(jcfg, None), ShardingPlan(cfg)
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0), jplan)
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params)))
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), plan, device="cpu",
                               model=model)
    jstep = jax.jit(JS.make_train_step(jcfg, jplan, lr_fn=jadamw.cosine_schedule(1e-3, 2, 10)))
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(1e-3, 2, 10), device="cpu")
    data = TokenStream(cfg.vocab, 4, 64)      # 2 sketch chunks a step: a flush at step 2
    lr_sum = 0.0
    for _ in range(2):
        host = data.next()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in host.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in host.items()})
        lr_sum += float(m["lr"])
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= 1e-5
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-4
        tree = S.checkpoint_tree(cfg, state)
        assert jax.tree.structure(jax.tree.map(np.asarray, jstate.params)) == \
            jax.tree.structure(jax.tree.map(lambda t: t.numpy(), tree.params))
        _assert_params_close(jstate.params, tree.params, lr_sum)
        for a, b in zip(jax.tree.leaves(jstate.token_sketch),
                        state_to_numpy(state.token_sketch)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert int(state.opt.count) == 2 and int(state.token_sketch.n.sum()) == 2 * 4 * 64


def _loss_grads(model, cfg, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = M.loss_fn(model, batch, cfg)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["full", "dots", "nested:2", "nested"])
@pytest.mark.parametrize("name", ARCHS)
def test_remat_policies_give_the_same_loss_and_grads(name, remat):
    cfg = get_smoke_arch(name, n_layers=4)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in TokenStream(cfg.vocab, 2, 32).next().items()}
    loss0, g0 = _loss_grads(model, dataclasses.replace(cfg, remat="none"), batch)
    loss, g = _loss_grads(model, dataclasses.replace(cfg, remat=remat), batch)
    assert torch.equal(loss, loss0)
    for n in g0:
        assert torch.equal(g[n], g0[n]), n
    assert g0["layers.0.mixer.dt_bias"].abs().max() > 0 and g0["layers.0.mixer.A_log"].abs().max() > 0


def test_shared_block_gradient_sums_its_applications(monkeypatch):
    """zamba2's smoke arch applies the shared block twice (after layers 2
    and 4); its gradient equals the sum of the two applications' gradients,
    each taken through a separate copy of the block."""
    cfg = get_smoke_arch("zamba2-7b", remat="none")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in TokenStream(cfg.vocab, 2, 32).next().items()}
    _, g = _loss_grads(model, cfg, batch)
    copies = [M.Block(cfg) for _ in range(2)]
    for c in copies:
        c.load_state_dict(model.shared_attn.state_dict())
        c.requires_grad_(True)
    real, uses = M._dense_block, iter(copies)

    def separate(block, *args, **kw):
        return real(next(uses) if block is model.shared_attn else block, *args, **kw)
    monkeypatch.setattr(M, "_dense_block", separate)
    model.zero_grad(set_to_none=True)
    M.loss_fn(model, batch, cfg)[0].backward()
    for n, p in copies[0].named_parameters():
        want = p.grad + dict(copies[1].named_parameters())[n].grad
        torch.testing.assert_close(g["shared_attn." + n], want, rtol=1e-5, atol=1e-7)
        assert p.grad.abs().max() > 0 and dict(copies[1].named_parameters())[n].grad.abs().max() > 0


def test_train_cli_runs_the_hybrid_family(tmp_path):
    out = train_cli.main(["--device", "cpu", "--arch", "zamba2-7b", "--smoke", "--steps", "4",
                          "--batch", "2", "--seq", "32", "--merge-every", "2",
                          "--log-every", "2", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert int(out["state"].opt.count) == 4 and [t["step"] for t in out["tops"]] == [2, 4]
    assert out["final"].recall == 1.0 and out["final"].precision == 1.0
    named = dict(out["state"].params.named_parameters())
    assert all(torch.equal(p, out["state"].opt.master[n].to(p.dtype)) for n, p in named.items())
    manifest = json.loads((tmp_path / "zamba2-7b" / "step_00000004" / "manifest.json").read_text())
    assert ".params['shared_attn']['wq']" in manifest["paths"]


# -- launch/train: crash and resume, within the port and across packages -----

ARCH = "mamba2-130m"
CLI = ["--arch", ARCH, "--smoke", "--steps", "8", "--batch", "2", "--seq", "64",
       "--ckpt-every", "4", "--merge-every", "4", "--log-every", "4"]


def _leaves(ckpt: Path, step: int) -> dict:
    d = ckpt / ARCH / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    arrays = np.load(d / "arrays.npz")
    return {p: arrays[f"leaf_{i}"] for i, p in enumerate(manifest["paths"])}


def _assert_sketches_equal(a: dict, b: dict):
    keys = [p for p in a if p.startswith((".token_sketch", ".expert_sketch", ".opt.count"))]
    assert len(keys) == 13       # 6 leaves a SketchState, and the count
    for p in keys:
        np.testing.assert_array_equal(a[p], b[p], err_msg=p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's uninterrupted run, the port's crash/resume, and each
    package resuming the other's step-4 checkpoint."""
    root = tmp_path_factory.mktemp("train_ssm")
    cpu = ("--device", "cpu")
    out = {"root": root, "port": train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port")])}
    with pytest.raises(SystemExit) as crash:
        train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_crash"), "--crash-at", "4"])
    out["crash_code"] = crash.value.code
    out["port_resumed"] = train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_crash")])
    jtrain.main([*CLI, "--ckpt-dir", str(root / "jax")])
    with pytest.raises(SystemExit):
        jtrain.main([*CLI, "--ckpt-dir", str(root / "jax_then_port"), "--crash-at", "4"])
    out["jax_then_port"] = train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "jax_then_port")])
    with pytest.raises(SystemExit):
        train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_then_jax"), "--crash-at", "4"])
    jtrain.main([*CLI, "--ckpt-dir", str(root / "port_then_jax")])
    return out


def test_main_crash_and_resume_reproduces_the_run(runs):
    whole, resumed = runs["port"], runs["port_resumed"]
    assert runs["crash_code"] == 42 and resumed["start"] == 4 and whole["start"] == 0
    np.testing.assert_array_equal(resumed["tokens"], whole["tokens"][4:])
    assert resumed["losses"] == whole["losses"][4:]
    assert resumed["grad_norms"] == whole["grad_norms"][4:]
    for a, b in zip(state_to_numpy(resumed["state"].token_sketch),
                    state_to_numpy(whole["state"].token_sketch)):
        np.testing.assert_array_equal(a, b)
    for name, t in whole["state"].params.state_dict().items():
        assert torch.equal(resumed["state"].params.state_dict()[name], t), name
    root = runs["root"]
    _assert_sketches_equal(_leaves(root / "port_crash", 8), _leaves(root / "port", 8))


@pytest.mark.parametrize("case,sketch_ref,param_ref", [
    ("jax_then_port", "port", "jax"), ("port_then_jax", "jax", "port")])
def test_either_package_resumes_the_others_checkpoint(runs, case, sketch_ref, param_ref):
    """The step-8 sketch is bitwise the resuming package's own
    uninterrupted run's (the sketch depends on the tokens only); params and
    master weights, the Mamba leaves included, are within the sign bound of
    steps 5–8 of the writing package's uninterrupted run."""
    root = runs["root"]
    got = _leaves(root / case, 8)
    assert got.keys() == _leaves(root / sketch_ref, 8).keys()
    _assert_sketches_equal(got, _leaves(root / sketch_ref, 8))
    want = _leaves(root / param_ref, 8)
    params = sorted(p for p in got if p.startswith((".params", ".opt.master")))
    assert any("dt_bias" in p for p in params) and any("A_log" in p for p in params)
    lr = adamw.cosine_schedule(3e-4, 20, 8)
    lr_sum = float(sum(lr(torch.tensor(s)) for s in range(5, 9)))
    _assert_params_close([want[p] for p in params], [got[p] for p in params], lr_sum)
    if case == "jax_then_port":
        assert runs["jax_then_port"]["start"] == 4
