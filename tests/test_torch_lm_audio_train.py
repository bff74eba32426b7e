"""The LM training path of the audio family (whisper-tiny) against the JAX
package's, on the CPU at f32 (the smoke arch, with the JAX package's
``init_params(PRNGKey(0))`` carried over by ``models/convert.py``; every
batch carries ``TokenStream.extras``' frames):

  * three train steps against JAX's jitted ``make_train_step`` under the
    full, dots and nested:2 remat policies (nested maps to a checkpoint a
    layer in both stacks, as JAX's ``lax.scan(_remat(body))``): loss
    within 1e-5 and grad norm within 1e-4 relative (the same f32
    operations, summed in other orders by XLA and ATen), params within
    the sign bound of ``test_torch_lm_train.py`` (2·Σlr + 1e-5, fewer than
    0.1% off by more than 1e-5), the token sketch bitwise after every
    step;
  * either package's trainer resumes the other's step-4 checkpoint of a
    whisper run (the encoder's and the cross attention's leaves
    included): the step-8 sketch bitwise the resuming package's own
    uninterrupted run, params and master weights within the sign bound of
    steps 5–8 of the writing package's uninterrupted run.
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
ARCH = "whisper-tiny"


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


@pytest.mark.parametrize("remat", ["full", "dots", "nested:2"])
def test_train_steps_equal_jax(remat):
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
    data = TokenStream(cfg.vocab, 4, 64)      # 2 sketch chunks a step: a flush at step 2
    lr_sum = 0.0
    for _ in range(3):
        host = data.next()
        host.update(data.extras(cfg))
        assert host["frames"].shape == (4, cfg.enc_dec.n_frames, cfg.d_model)
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
    assert int(state.opt.count) == 3 and int(state.token_sketch.n.sum()) == 3 * 4 * 64


# -- launch/train: either package resumes the other's whisper checkpoint ------

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
    """Each package's uninterrupted run, and each package resuming the
    other's step-4 checkpoint."""
    root = tmp_path_factory.mktemp("train_audio")
    cpu = ("--device", "cpu")
    out = {"root": root, "port": train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port")])}
    jtrain.main([*CLI, "--ckpt-dir", str(root / "jax")])
    with pytest.raises(SystemExit):
        jtrain.main([*CLI, "--ckpt-dir", str(root / "jax_then_port"), "--crash-at", "4"])
    out["jax_then_port"] = train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "jax_then_port")])
    with pytest.raises(SystemExit) as crash:
        train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_then_jax"), "--crash-at", "4"])
    out["crash_code"] = crash.value.code
    jtrain.main([*CLI, "--ckpt-dir", str(root / "port_then_jax")])
    return out


@pytest.mark.parametrize("case,sketch_ref,param_ref", [
    ("jax_then_port", "port", "jax"), ("port_then_jax", "jax", "port")])
def test_either_package_resumes_the_others_checkpoint(runs, case, sketch_ref, param_ref):
    root = runs["root"]
    got = _leaves(root / case, 8)
    assert got.keys() == _leaves(root / sketch_ref, 8).keys()
    _assert_sketches_equal(got, _leaves(root / sketch_ref, 8))
    want = _leaves(root / param_ref, 8)
    params = sorted(p for p in got if p.startswith((".params", ".opt.master")))
    assert any("['enc_layers']" in p for p in params)
    assert any("['cross_wk']" in p for p in params) and any("enc_final_norm" in p for p in params)
    lr = adamw.cosine_schedule(3e-4, 20, 8)
    lr_sum = float(sum(lr(torch.tensor(s)) for s in range(5, 9)))
    _assert_params_close([want[p] for p in params], [got[p] for p in params], lr_sum)
    if case == "jax_then_port":
        assert runs["jax_then_port"]["start"] == 4
    else:
        assert runs["crash_code"] == 42


def test_the_port_run_trains_on_the_jax_batches(runs):
    """The port's uninterrupted run: the JAX run's batches (its step-8
    sketch bitwise the JAX run's), finite losses, params bitwise their
    masters."""
    root = runs["root"]
    _assert_sketches_equal(_leaves(root / "port", 8), _leaves(root / "jax", 8))
    out = runs["port"]
    assert len(out["losses"]) == 8 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    named = dict(out["state"].params.named_parameters())
    assert any(n.startswith("encoder.") for n in named)
    assert all(torch.equal(p, out["state"].opt.master[n].to(p.dtype)) for n, p in named.items())
