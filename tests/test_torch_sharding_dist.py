"""The sharded LM steps of the port over 8 gloo ranks on the CPU.

One subprocess starts a world of 8 ranks (``launch/mesh.py:spawn_ranks``,
gloo). On a ``(2, 4)`` ``data × model`` mesh, qwen2.5-14b's smoke arch (2
layers, d 128, 4/4 heads, vocab 512, f32) runs on DTensors placed by
``train/steps.py``'s shardings:

  * the train state built on the mesh from a seed (``init_train_state``,
    one unit at a time): every parameter bitwise the single-process
    state's, its master an f32 copy, its moments zeros in its placements;
  * two train steps from the JAX package's ``init_params(PRNGKey(0))``
    (carried over by ``models/convert.py``) on two TokenStream batches of
    B 4 × S 32. After the first: the loss and the gradient norm within
    1e-5 relative of the port's single-process step's, the loss within
    1e-3 of JAX's jitted step (JAX's
    ``test_sharded_train_step_matches_single_device`` bound) and the norm
    within 1e-5 relative of its; every gradient, read as the first moment
    the step left (m = (1 − b1)·g after clipping), within 1e-5 of the
    largest of its leaf beside the single-process step's (1e-4 beside
    JAX's); every parameter within 4·lr + 1e-5 (Adam moves
    a parameter by about ±lr whatever its gradient's size), ``lm_head``
    within 5e-2 of JAX's too. The second step's loss, which the first
    step's update decides, within 1e-5 relative again. The token sketch
    (2 groups, one a data rank) bitwise a single-process ``sorted``
    engine of 2 tenants fed the same batches;
  * a prefill of the first batch's 32 tokens and 4 greedy decode steps
    with the cache in ``cache_shardings`` (its sequence dim on ``model``):
    the prefill's last logits and every decode step's within 1e-5 of the
    single-process steps', the same 4 tokens, no redistribution of a
    tensor of the cache's shape (decode attention scores each rank's own
    positions), and the serving sketch bitwise a ``sorted`` engine of 2
    tenants fed the same tokens;
  * ``wsc(x, "bshd")`` of a (2, 16, 40, 128) bf16 tensor on a ``(1, 8)``
    mesh of the same world (qwen2.5-14b's 40 heads: the case of JAX's
    ``test_uneven_heads_constraint_compiles``): heads sharded, and its
    ``full_tensor()`` exactly ``x``.

Rank 0 writes what it saw to an ``.npz``; the test compares it here and
prints the measured gaps (``pytest -s`` shows them).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ARCH = "qwen2.5-14b"
B, SEQ, GEN, STEPS = 4, 32, 4, 2
LR = (1e-2, 2, 10)          # cosine_schedule(base, warmup, total): lr 5e-3 at step 1
SKETCH_LEAVES = ((0, "items"), (1, "counts"), (2, "errors"), (3, "buffer"), (5, "n"))


def _train_batches(cfg) -> list:
    from repro_torch.data.synthetic import TokenStream
    stream = TokenStream(cfg.vocab, B, SEQ)
    return [stream.next() for _ in range(STEPS)]


def _spy_decode(M, on_step):
    """Wrap ``M.decode_step`` (which the serve step calls) so that
    ``on_step(logits, during)`` sees each step's logits; ``during`` is a
    list that holds True while the real decode step runs."""
    real, during = M.decode_step, []

    def decode_step(*args, **kwargs):
        during.append(True)
        try:
            out = real(*args, **kwargs)
        finally:
            during.clear()
        on_step(out[0])
        return out
    M.decode_step = decode_step
    return during


def _whole(t) -> np.ndarray:
    """A DTensor's global value as a numpy copy (``full_tensor()`` of a
    replicated DTensor is its local tensor itself, which a later in-place
    update would change)."""
    return t.full_tensor().detach().clone().numpy()


def _sketch_record(rec: dict, prefix: str, sk) -> None:
    for name, t in zip(("items", "counts", "errors"), sk.summary):
        rec[f"{prefix}/{name}"] = _whole(t)
    rec[f"{prefix}/buffer"] = _whole(sk.buffer)
    rec[f"{prefix}/n"] = _whole(sk.n)


def _ranks(weights: str, out: str) -> dict:
    """Every rank: the sharded steps; rank 0 saves their results to ``out``."""
    import torch.distributed as dist
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg = get_smoke_arch(ARCH)
    mesh = make_mesh_shape((2, 4), ("data", "model"), device_type="cpu")
    plan = ShardingPlan(cfg, mesh)
    rec = {}

    # the state built on the mesh from a seed
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), plan, device="cpu")
    for name, p in state.params.named_parameters():
        rec["init/" + name] = _whole(p)
    rec["init_opt_ok"] = np.bool_(all(
        isinstance(t, DTensor) and t.placements == p.placements
        and torch.equal(state.opt.master[n].to_local(), p.to_local().float())
        and not state.opt.m[n].to_local().any() and not state.opt.v[n].to_local().any()
        for n, p in state.params.named_parameters() for t in (state.opt.master[n],
                                                              state.opt.m[n], state.opt.v[n]))
        and int(state.opt.count.full_tensor()) == 0)
    del state

    params = torch.load(weights)

    def model():
        m = M.build_params(cfg, "cpu")
        m.load_state_dict(params)
        return S.distribute_model(cfg, plan, m)

    hosts = _train_batches(cfg)
    pl = S.batch_shardings(cfg, plan, {k: torch.from_numpy(v) for k, v in hosts[0].items()})
    batches = [{k: S._distribute(torch.from_numpy(v), mesh, pl[k]) for k, v in h.items()}
               for h in hosts]
    state = S.init_train_state(cfg, torch.Generator(), plan, device="cpu", model=model())
    raw = {}        # the gradients' placements as the backward leaves them

    def seen(name):
        def hook(p):
            raw[name] = str(p.grad.placements)
        return hook
    hooks = [p.register_post_accumulate_grad_hook(seen(n))
             for n, p in state.params.named_parameters()]
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(*LR), device="cpu")
    state, metrics = step(state, batches[0])
    for h in hooks:
        h.remove()
    rec.update(loss=metrics["loss"].numpy(), grad_norm=metrics["grad_norm"].numpy(),
               lr=metrics["lr"].numpy())
    for name, p in state.params.named_parameters():
        rec["param/" + name] = _whole(p)
        rec["m/" + name] = _whole(state.opt.m[name])
        rec["raw_grad/" + name] = raw[name]
        rec["placement/" + name] = str(p.placements)
    state, metrics = step(state, batches[1])
    rec.update(loss2=metrics["loss"].numpy(), grad_norm2=metrics["grad_norm"].numpy())
    _sketch_record(rec, "train_sketch", state.token_sketch)
    del state

    served = model()
    last, cache = S.make_prefill_step(cfg, plan)(served, {"tokens": batches[0]["tokens"]})
    cache = S.distribute_cache(cfg, plan, cache, SEQ + GEN)
    rec["placement/cache_k"] = str(cache["k"].placements)
    cache_shapes = {tuple(cache["k"].shape), tuple(cache["k"].shape[1:])}
    serve = S.make_serve_step(cfg, plan, device="cpu")
    groups = S.sketch_groups(plan)
    sketch = SK.distribute_sketch(plan, SK.init_token_sketch(cfg.sketch, groups,
                                                             chunk=B // groups, device="cpu"))
    logits, moves = [], []
    during = _spy_decode(M, lambda lg: logits.append(lg[:, -1].full_tensor()))
    real_move = redistribute.redistribute_local_tensor

    def move(local, current, target, *args, **kwargs):
        if during and current.placements != target.placements:
            moves.append((str(current.placements), str(target.placements),
                          tuple(current.shape)))
        return real_move(local, current, target, *args, **kwargs)

    redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = move
    tokens, emitted = last.argmax(-1).to(torch.int32), []
    try:
        for i in range(GEN):
            tokens, cache, sketch = serve(served, cache, tokens[:, None], SEQ + i, sketch)
            emitted.append(tokens.full_tensor())
    finally:
        redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = real_move
    rec["prefill_last"] = _whole(last)
    rec["decode_logits"] = torch.stack(logits, 1).numpy()
    rec["decoded"] = torch.stack(emitted, 1).numpy()
    rec["decode_moves"] = np.int64(len(moves))
    rec["decode_moves_cache_shaped"] = np.int64(sum(m[2] in cache_shapes for m in moves))
    _sketch_record(rec, "serve_sketch", sketch)

    heads_plan = ShardingPlan(get_arch(ARCH), make_mesh_shape((1, 8), ("data", "model"),
                                                              device_type="cpu"))
    x = torch.randn((2, 16, 40, 128), generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    y = heads_plan.wsc(DTensor.from_local(x, heads_plan.mesh, [Replicate(), Replicate()]),
                       "bshd")
    rec["placement/bshd"] = str(y.placements)
    rec["bshd_local_heads"] = np.int64(y.to_local().shape[2])
    rec["bshd_round_trip"] = np.bool_(torch.equal(y.full_tensor(), x))
    if dist.get_rank() == 0:
        np.savez(out, **rec)
    return {"world": dist.get_world_size()}


def test_sharded_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke_arch as jax_smoke_arch
    from repro.optim import adamw as jadamw
    from repro.sharding.rules import ShardingPlan as JShardingPlan
    from repro.train import steps as JS
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.core.parallel import block_decompose
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg, jcfg = get_smoke_arch(ARCH), jax_smoke_arch(ARCH)
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0), JShardingPlan(jcfg, None))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params))
    torch.save(params, tmp_path / "weights.pt")
    out = tmp_path / "ranks.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans"),
               PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parents[1] / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    env.pop("REPRO_TORCH_PLAN_FILE", None)
    proc = subprocess.run([sys.executable, __file__, str(tmp_path / "weights.pt"), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"world": 8}
    got = dict(np.load(out))
    plan = ShardingPlan(cfg)

    # the state built on the mesh from a seed: the single-process state's
    init = S.init_train_state(cfg, torch.Generator().manual_seed(0), plan, device="cpu")
    for name, p in init.params.named_parameters():
        np.testing.assert_array_equal(got["init/" + name], p.detach().numpy(), err_msg=name)
    assert bool(got["init_opt_ok"])

    # the port's single-process train steps, and JAX's, on the same batches
    hosts = _train_batches(cfg)
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params)
    state = S.init_train_state(cfg, torch.Generator(), plan, device="cpu", model=model)
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(*LR), device="cpu")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in hosts[0].items()})
    after1 = {n: (p.detach().clone().numpy(), state.opt.m[n].clone().numpy())
              for n, p in state.params.named_parameters()}
    state, m2 = step(state, {k: torch.from_numpy(v) for k, v in hosts[1].items()})
    jstep = jax.jit(JS.make_train_step(jcfg, JShardingPlan(jcfg, None),
                                       lr_fn=jadamw.cosine_schedule(*LR)))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in hosts[0].items()})
    jparams = {"lm_head": np.asarray(jstate.params["lm_head"])}
    jmom = params_from_jax(cfg, jax.tree.map(np.asarray, jstate.opt.m))
    jstate, jm2 = jstep(jstate, {k: jnp.asarray(v) for k, v in hosts[1].items()})

    def rel(a, b):
        return abs(float(a) / float(b) - 1)

    def leaf_gap(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    gaps = {"loss_rel": rel(got["loss"], m["loss"]),
            "loss_vs_jax": abs(float(got["loss"]) - float(jm["loss"])),
            "grad_norm_rel": rel(got["grad_norm"], m["grad_norm"]),
            "grad_norm_rel_vs_jax": rel(got["grad_norm"], jm["grad_norm"]),
            "grads_rel": max(leaf_gap(got["m/" + n], mom) for n, (_, mom) in after1.items()),
            "grads_rel_vs_jax": max(leaf_gap(got["m/" + n], jmom[n].numpy())
                                    for n in after1),
            "loss2_rel": rel(got["loss2"], m2["loss"]),
            "loss2_vs_jax": abs(float(got["loss2"]) - float(jm2["loss"])),
            "grad_norm2_rel": rel(got["grad_norm2"], m2["grad_norm"]),
            "lr": float(m["lr"]),
            "params": max(float(np.abs(got["param/" + n] - p).max())
                          for n, (p, _) in after1.items()),
            "lm_head_vs_jax": float(np.abs(got["param/lm_head"] - jparams["lm_head"]).max()),
            "grads_in_other_placements": sum(bool(got["raw_grad/" + n] != got["placement/" + n])
                                             for n in after1),
            "grads": len(after1)}
    assert gaps["loss_rel"] <= 1e-5 and gaps["loss_vs_jax"] < 1e-3
    assert gaps["grad_norm_rel"] <= 1e-5 and gaps["grad_norm_rel_vs_jax"] <= 1e-5
    assert gaps["grads_rel"] <= 1e-5 and gaps["grads_rel_vs_jax"] <= 1e-4
    assert gaps["loss2_rel"] <= 1e-5 and gaps["loss2_vs_jax"] < 1e-3
    assert gaps["grad_norm2_rel"] <= 1e-5
    assert float(got["lr"]) == float(m["lr"])
    assert gaps["params"] <= 4 * float(m["lr"]) + 1e-5
    assert gaps["lm_head_vs_jax"] < 5e-2
    # the backward left gradients in other placements (a Partial sum over
    # data), and the step put each back in its parameter's before the update
    assert gaps["grads_in_other_placements"] > 0
    assert got["placement/layers.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"  # FSDP, TP

    # the token sketch: one tenant a data rank, as 2 tenants on one process
    sorted_sk = dataclasses.replace(cfg.sketch, kernel="sorted")
    engine = SK.token_engine(sorted_sk, 2, device="cpu")
    ref = engine.init()
    for host in hosts:
        ref = engine.ingest(ref, block_decompose(torch.from_numpy(host["tokens"])
                                                 .reshape(-1), 2))
    want = state_to_numpy(ref)
    for i, name in SKETCH_LEAVES:
        np.testing.assert_array_equal(got["train_sketch/" + name], want[i], err_msg=name)

    # prefill and 4 decode steps against the single-process steps
    tokens = torch.from_numpy(hosts[0]["tokens"])
    model.load_state_dict(params)              # the train steps moved the weights
    last, cache = S.make_prefill_step(cfg, plan)(model, {"tokens": tokens})
    cache = pad_cache(cache, SEQ + GEN)
    serve = S.make_serve_step(cfg, plan, device="cpu")
    sketch = SK.init_token_sketch(cfg.sketch, 1, chunk=B, device="cpu")
    logits = []
    monkeypatch.setattr(M, "decode_step", M.decode_step)   # restored after the test
    _spy_decode(M, lambda lg: logits.append(lg[:, -1]))
    nxt, emitted = last.argmax(-1).to(torch.int32), []
    for i in range(GEN):
        nxt, cache, sketch = serve(model, cache, nxt[:, None], SEQ + i, sketch)
        emitted.append(nxt)
    gaps["prefill_last_logits"] = float(np.abs(got["prefill_last"] - last.numpy()).max())
    gaps["decode_logits"] = float(np.abs(got["decode_logits"]
                                         - torch.stack(logits, 1).numpy()).max())
    gaps["decode_moves"] = int(got["decode_moves"])
    gaps["decode_moves_cache_shaped"] = int(got["decode_moves_cache_shaped"])
    print(json.dumps({"gaps": gaps}))
    assert gaps["prefill_last_logits"] <= 1e-5
    assert gaps["decode_logits"] <= 1e-5
    np.testing.assert_array_equal(got["decoded"], torch.stack(emitted, 1).numpy())
    assert got["placement/cache_k"] == "(Shard(dim=1), Shard(dim=2))"  # batch, sequence
    # the decode redistributed tensors (the new token's q/k/v, the FSDP
    # weights), never one of the cache's shape
    assert gaps["decode_moves"] > 0 and gaps["decode_moves_cache_shaped"] == 0
    engine = SK.token_engine(sorted_sk, 2, chunk=B // 2, device="cpu")
    ref = engine.init()
    for i in range(GEN):
        ref = engine.ingest(ref, block_decompose(torch.from_numpy(got["decoded"][:, i]), 2))
    want = state_to_numpy(ref)
    for i, name in SKETCH_LEAVES:
        np.testing.assert_array_equal(got["serve_sketch/" + name], want[i], err_msg=name)

    assert got["placement/bshd"] == "(Shard(dim=0), Shard(dim=2))"
    assert int(got["bshd_local_heads"]) == 5
    assert bool(got["bshd_round_trip"])


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks
    print(json.dumps(spawn_ranks(8, _ranks, sys.argv[1], sys.argv[2])))
