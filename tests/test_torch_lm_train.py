"""The LM training path of the port against the JAX package's, on the CPU.

qwen2.5-14b's smoke arch (2 layers, d 128, f32), with the JAX package's
``init_params(PRNGKey(0))`` carried over by ``models/convert.py``:

  * ``train/steps.py:make_train_step``: 3 steps against JAX's jitted
    ``make_train_step`` on the same TokenStream batches. Loss within 1e-5
    relative and grad norm within 1e-4 relative (the same f32 operations,
    summed in other orders by XLA and ATen), ``lr`` and ``count`` equal,
    m within 1e-3 of its largest entry. Params within 2·Σlr + 1e-5
    absolute, and fewer than 0.1% of them off by more than 1e-5: Adam's
    first steps move a parameter by about ±lr whatever its gradient's size,
    so a gradient near 0 whose sign differs between the two packages moves
    it by up to 2·lr a step (the sign hazard). The token sketch bitwise
    after every step.
  * every remat policy (none, full, dots, nested:2, and tiles under full)
    gives the same loss and grads, bit for bit (a checkpoint recomputes
    the same operations on the same inputs); ``dots`` recomputes no
    weight product.
  * the ports of JAX's ``test_train_step_updates_everything`` and
    ``test_token_sketch_tracks_stream_exactly``.
  * ``launch/train.main`` with ``--crash-at 4``, then resumed to step 8:
    the same batches, token sketch, losses and params as the uninterrupted
    run, bit for bit (the checkpoint holds every f32 tensor exactly).
  * either package's trainer resumes the other's step-4 checkpoint: the
    step-8 sketch bitwise the resuming package's own uninterrupted run,
    params within the sign bound.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro.train import steps as JS
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.core.exact import evaluate, overestimation_violations
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import state_to_numpy
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK
from repro_torch.train import steps as S

torch.set_num_threads(1)
ARCH = "qwen2.5-14b"
CLI = ["--arch", ARCH, "--smoke", "--steps", "8", "--batch", "2", "--seq", "64",
       "--ckpt-every", "4", "--merge-every", "4", "--log-every", "1"]


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


def _pin(c, kernel="sorted"):
    return dataclasses.replace(c, sketch=dataclasses.replace(c.sketch, kernel=kernel))


def _setup(**overrides):
    """(jax cfg, jax state, port cfg, port state) holding JAX's weights."""
    cfg, jcfg = _pin(get_smoke_arch(ARCH, **overrides)), _pin(jax_smoke_arch(ARCH, **overrides))
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0), JShardingPlan(jcfg, None))
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params)))
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), ShardingPlan(cfg),
                               device="cpu", model=model)
    return jcfg, jstate, cfg, state


def _batch(host: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in host.items()}


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


def test_train_steps_equal_jax():
    jcfg, jstate, cfg, state = _setup()
    jplan, plan = JShardingPlan(jcfg, None), ShardingPlan(cfg)
    jstep = jax.jit(JS.make_train_step(jcfg, jplan, lr_fn=jadamw.cosine_schedule(1e-2, 2, 10)))
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(1e-2, 2, 10),
                             device="cpu")
    data = TokenStream(cfg.vocab, 4, 64)       # 2 chunks a step: a flush at step 2
    lr_sum = 0.0
    for i in range(3):
        host = data.next()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in host.items()})
        state, m = step(state, _batch(host))
        lr_sum += float(m["lr"])
        assert abs(float(m["loss"]) / float(jm["loss"]) - 1) <= 1e-5
        assert abs(float(m["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-4
        assert np.float32(m["lr"].item()) == np.float32(jm["lr"])
        assert int(state.opt.count) == int(jstate.opt.count) == i + 1
        tree = S.checkpoint_tree(cfg, state)
        _assert_params_close(jstate.params, tree.params, lr_sum)
        _assert_params_close(jstate.opt.master, tree.opt.master, lr_sum)
        for a, b in zip(jax.tree.leaves(jstate.opt.m), jax.tree.leaves(tree.opt.m)):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, atol=1e-3 * np.abs(a).max())
        for a, b in zip(jax.tree.leaves(jstate.token_sketch),
                        state_to_numpy(state.token_sketch)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_train_state_layout_equals_jax():
    """The checkpoint tree of the port's state has JAX's TrainState paths,
    shapes and dtypes, live and as ``train_state_shapes``."""
    from repro_torch.checkpoint.manager import _flatten
    jcfg, jstate, cfg, state = _setup()
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jstate)[0]]
    jleaves = jax.tree.leaves(jstate)
    shapes = S.train_state_shapes(cfg, ShardingPlan(cfg))
    assert all(t.device.type == "meta" for t in shapes.params.values())
    for tree in (S.checkpoint_tree(cfg, state), S.checkpoint_tree(cfg, shapes)):
        paths, leaves, _ = _flatten(tree)
        assert paths == jpaths
        for p, a, b in zip(paths, jleaves, leaves):
            shape = tuple(b.shape) if hasattr(b, "shape") else ()
            dtype = str(b.dtype).replace("torch.", "") if hasattr(b, "dtype") else "int32"
            assert (shape, dtype) == (tuple(a.shape), jnp.dtype(a.dtype).name), p


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _loss_and_grads(model, cfg, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = M.loss_fn(model, batch, cfg)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat,tiles", [("full", False), ("dots", False),
                                         ("nested:2", False), ("nested", False),
                                         ("full", True), ("none", True)])
def test_remat_policies_give_the_same_loss_and_grads(remat, tiles):
    cfg = get_smoke_arch(ARCH, n_layers=4)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    host = TokenStream(cfg.vocab, 2, 64).next()
    loss0, g0 = _loss_and_grads(model, dataclasses.replace(cfg, remat="none"), _batch(host))
    loss, g = _loss_and_grads(model, dataclasses.replace(cfg, remat=remat,
                                                         attn_remat_tiles=tiles), _batch(host))
    assert torch.equal(loss, loss0)
    for name in g0:
        assert torch.equal(g[name], g0[name]), name


def test_dots_policy_recomputes_no_weight_product():
    cfg = get_smoke_arch(ARCH)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    batch = _batch(TokenStream(cfg.vocab, 2, 64).next())
    counts = {}
    for remat in ("none", "full", "dots"):
        with _CountMM() as mode:
            _loss_and_grads(model, dataclasses.replace(cfg, remat=remat), batch)
        counts[remat] = mode.mm
    # full remat recomputes a layer's weight products in the backward; dots
    # keeps their outputs and recomputes none of them
    assert counts["dots"] == counts["none"] < counts["full"]


def test_unknown_remat_raises():
    cfg = dataclasses.replace(get_smoke_arch(ARCH), remat="most")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    with pytest.raises(ValueError, match="remat"):
        M.loss_fn(model, _batch(TokenStream(cfg.vocab, 2, 64).next()), cfg)


def test_serving_forward_records_no_graph():
    cfg = get_smoke_arch(ARCH)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _ = M.forward(model, _batch(TokenStream(cfg.vocab, 2, 16).next()), cfg)
    assert logits.grad_fn is None


def test_train_step_updates_everything():
    _, _, cfg, state = _setup()
    step = S.make_train_step(cfg, ShardingPlan(cfg), device="cpu")
    before = {n: t.clone() for n, t in state.params.state_dict().items()}
    n_before = int(state.token_sketch.n.sum())
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    state, metrics = step(state, {"tokens": tokens, "labels": tokens})
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(state.opt.count) == 1
    after = state.params.state_dict()
    assert max(float((after[n] - before[n]).abs().max()) for n in before) > 0
    assert all(p.grad is None for p in state.params.parameters())
    assert int(state.token_sketch.n.sum()) == n_before + 4 * 64
    merged = SK.merge_sketches(SK.token_engine(cfg.sketch, 1, device="cpu"),
                               state.token_sketch)
    assert int(merged.counts.sum()) > 0


def test_token_sketch_tracks_stream_exactly():
    _, _, cfg, state = _setup()
    step = S.make_train_step(cfg, ShardingPlan(cfg), device="cpu")
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(6):
        toks = np.minimum(rng.zipf(1.3, (4, 64)), cfg.vocab - 1).astype(np.int32)
        seen.append(toks.reshape(-1))
        state, _ = step(state, _batch({"tokens": toks, "labels": toks}))
    merged = SK.merge_sketches(SK.token_engine(cfg.sketch, 1, device="cpu"),
                               state.token_sketch)
    stream = np.concatenate(seen)
    assert overestimation_violations(merged, stream) == 0
    assert evaluate(merged, stream, 32).recall == 1.0


def test_train_cli_runs_the_audio_family(tmp_path):
    """``launch/train.main`` on whisper-tiny's smoke arch: the stream's
    frames go with every batch, the encoder trains, the checkpoint holds
    the JAX layout's encoder-decoder leaves."""
    out = train_cli.main(["--device", "cpu", "--arch", "whisper-tiny", "--smoke", "--steps",
                          "4", "--batch", "2", "--seq", "32", "--merge-every", "2",
                          "--log-every", "2", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert int(out["state"].opt.count) == 4 and [t["step"] for t in out["tops"]] == [2, 4]
    assert out["final"].recall == 1.0 and out["final"].precision == 1.0
    master = out["state"].opt.master
    start = M.init_params(get_smoke_arch("whisper-tiny"), torch.Generator("cpu").manual_seed(0))
    assert not torch.equal(master["encoder.layers.0.attn.wq"],
                           start.encoder.layers[0].attn.wq)
    manifest = json.loads((tmp_path / "whisper-tiny" / "step_00000004" / "manifest.json")
                          .read_text())
    assert ".params['enc_layers']['wq']" in manifest["paths"]
    assert ".params['dec_layers']['cross_wk']" in manifest["paths"]
    assert ".opt.master['enc_final_norm_scale']" in manifest["paths"]


# -- launch/train: crash and resume, within the port and across packages -----

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


def _crash_then_resume(main, ckpt, device_args=()):
    with pytest.raises(SystemExit) as crash:
        main([*device_args, *CLI, "--ckpt-dir", str(ckpt), "--crash-at", "4"])
    assert crash.value.code == 42
    return main([*device_args, *CLI, "--ckpt-dir", str(ckpt)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every trainer run of the cases below, once: each package's
    uninterrupted run, the port's crash/resume, and each package resuming
    the other's step-4 checkpoint."""
    root = tmp_path_factory.mktemp("train")
    cpu = ("--device", "cpu")
    out = {"root": root, "port": train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port")])}
    out["port_resumed"] = _crash_then_resume(train_cli.main, root / "port_crash", cpu)
    jtrain.main([*CLI, "--ckpt-dir", str(root / "jax")])
    # JAX writes step 4, the port resumes it; and the other way round
    with pytest.raises(SystemExit):
        jtrain.main([*CLI, "--ckpt-dir", str(root / "jax_then_port"), "--crash-at", "4"])
    out["jax_then_port"] = train_cli.main([*cpu, *CLI, "--ckpt-dir",
                                           str(root / "jax_then_port")])
    with pytest.raises(SystemExit):
        train_cli.main([*cpu, *CLI, "--ckpt-dir", str(root / "port_then_jax"),
                        "--crash-at", "4"])
    jtrain.main([*CLI, "--ckpt-dir", str(root / "port_then_jax")])
    return out


def test_main_crash_and_resume_reproduces_the_run(runs, capsys):
    whole, resumed = runs["port"], runs["port_resumed"]
    assert resumed["start"] == 4 and whole["start"] == 0
    np.testing.assert_array_equal(resumed["tokens"], whole["tokens"][4:])
    assert resumed["losses"] == whole["losses"][4:]
    assert resumed["grad_norms"] == whole["grad_norms"][4:]
    for a, b in zip(state_to_numpy(resumed["state"].token_sketch),
                    state_to_numpy(whole["state"].token_sketch)):
        np.testing.assert_array_equal(a, b)
    for name, t in whole["state"].params.state_dict().items():
        assert torch.equal(resumed["state"].params.state_dict()[name], t), name
    assert resumed["final"].recall == 1.0 and resumed["final"].precision == 1.0
    assert [t["step"] for t in whole["tops"]] == [4, 8]
    root = runs["root"]
    _assert_sketches_equal(_leaves(root / "port_crash", 8), _leaves(root / "port", 8))


def test_main_prints_resume_and_reports(tmp_path, capsys):
    args = ["--device", "cpu", *CLI, "--steps", "4", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(SystemExit):
        train_cli.main([*args, "--crash-at", "2"])
    out = capsys.readouterr().out
    assert "[crash] simulated failure at step 2" in out
    train_cli.main(args)
    out = capsys.readouterr().out
    assert f"[resume] restored step 2 from {tmp_path / ARCH}" in out
    assert "[sketch] step 4 top tokens:" in out
    assert "[sketch-final] k-majority(k=100)" in out and "recall=1.000" in out


@pytest.mark.parametrize("case,sketch_ref,param_ref", [
    ("jax_then_port", "port", "jax"), ("port_then_jax", "jax", "port")])
def test_either_package_resumes_the_others_checkpoint(runs, case, sketch_ref, param_ref):
    """``jax_then_port``: JAX's trainer wrote step 4 and the port's resumed
    it to step 8; ``port_then_jax`` the other way round. The step-8 sketch
    is bitwise the resuming package's own uninterrupted run's (the sketch
    depends on the tokens only); params and master weights are within the
    sign bound of steps 5–8 of the writing package's uninterrupted run."""
    root = runs["root"]
    got = _leaves(root / case, 8)
    assert got.keys() == _leaves(root / sketch_ref, 8).keys()
    _assert_sketches_equal(got, _leaves(root / sketch_ref, 8))
    want = _leaves(root / param_ref, 8)
    params = sorted(p for p in got if p.startswith((".params", ".opt.master")))
    lr = adamw.cosine_schedule(3e-4, 20, 8)
    lr_sum = float(sum(lr(torch.tensor(s)) for s in range(5, 9)))
    _assert_params_close([want[p] for p in params], [got[p] for p in params], lr_sum)
    if case == "jax_then_port":
        assert runs["jax_then_port"]["start"] == 4
