"""The sharded LM steps of the port over 8 gloo ranks on the CPU, and the
harness that every family's world shares (``test_torch_sharding_mla.py``,
``_moe_ep.py``, ``_moe_tp.py``, ``_ssm.py``, ``_hybrid.py``, ``_audio.py``,
``_vlm.py``: one world a file, so that ``--dist loadfile`` spreads them
over workers).

:func:`check` saves the JAX package's ``init_params(PRNGKey(0))`` of an
arch's smoke config (f32, carried over by ``models/convert.py``) and runs
this file as a script in a subprocess, which starts a world of 8 ranks
(``launch/mesh.py:spawn_ranks``, gloo, ``OMP_NUM_THREADS=1``). On a
``(2, 4)`` ``data × model`` mesh under the given ``moe_strategy`` every
rank runs (:func:`ranks`):

  * the train state built on the mesh from a seed (``init_train_state``,
    one unit at a time);
  * two train steps of two TokenStream batches of B 4 × S 32, with the
    modality inputs drawn with numpy from a seed (whisper's frames,
    qwen2-vl's patch embeddings and random (3, B, S) positions) (the loss, the
    gradient norm, every gradient read as the first moment the first step
    left, every parameter after each step, the placements the backward
    gave the gradients; for MoE the expert counts, the aux loss and the
    expert sketch of every rank, gathered to rank 0);
  * a prefill of the first batch (its modality inputs too) and 4 greedy
    decode steps with the cache
    in ``cache_shardings`` (every step's logits, the tokens, the
    redistributions of the decode steps and how many had a cache's shape);
  * for MoE, every call of the dispatch and combine helpers recorded (no
    DTensor argument, only the rank's batch rows); under
    ``launch/hlo_analysis.StepCounter`` (the dry run's counter, which
    counts the collectives ``CommDebugMode`` counts) one MoE layer, one
    absorbed MLA decode (``mla.mla_decode``), one Mamba decode layer (and
    whether it wrote layer 0 of the stacked state and window through their
    shards, and nothing else), one whisper
    cross-attention decode or one vlm decode attention: the collectives
    DTensor issued and the bytes each rank handed them, and the
    redistributions with their shapes;
  * a world's own records (``extra``, a function of this module).

Rank 0 writes what it saw to an ``.npz``. :func:`check` then runs the
port's single-process steps and JAX's jitted single-device train step on
the same weights and batches and holds the ranks' results to them:

  * the seeded state bitwise the single-process one, its master an f32
    copy, its moments zeros in its placements;
  * the loss and grad norm within 1e-5 relative of the port's, the loss
    within 1e-3 of JAX's (JAX's
    ``test_sharded_train_step_matches_single_device`` bound) and the norm
    within 1e-5 relative of its; every gradient, read as the first moment
    (m = (1 − b1)·g after clipping), within 1e-5 of its leaf's largest
    beside the port's and 1e-4 beside JAX's (a leaf whose gradient is zero
    in exact arithmetic, whisper's key biases, of the model's largest);
    for MoE the aux loss within 1e-5 relative of both;
  * every parameter after each step within 0.1·lr of the port's (Adam
    moves a parameter by about lr whatever its gradient's size, so a
    wrong, skipped or misplaced update moves it by about lr), and
    ``lm_head`` after the first step within 5e-2 of JAX's; the second
    step's loss and grad norm within 1e-5 relative again;
  * the prefill's and every decode step's logits within 1e-5, the tokens
    equal;
  * bitwise: the token sketches (against a ``sorted`` engine of 2 tenants
    fed the same tokens), and for MoE the expert counts and the expert
    sketch (the same on every rank, and a single-process ``sorted`` expert
    engine's fed the same counts);
  * no decode redistribution of a tensor of a cache's shape.

A world may state its own bounds for the gradients, the parameters and
the logits (``check``'s ``grads_rtol``, ``params_lr``, ``logits_atol``),
with the measurement behind them in its docstring: the hybrid world does.
The MoE steps peak at lr 1e-6 (phase 13's card-vs-CPU rate), so that the
first update cannot flip a route; the smallest gap between a token's k-th
and (k+1)-th router probability the ranks saw is printed with the gaps
(``pytest -s``).

This file's own world is qwen2.5-14b's smoke arch (2 layers, d 128, 4/4
heads, vocab 512) under ``tp``, and also ``wsc(x, "bshd")`` of a
(2, 16, 40, 128) bf16 tensor on a ``(1, 8)`` mesh of the same world
(qwen2.5-14b's 40 heads: the case of JAX's
``test_uneven_heads_constraint_compiles``): heads sharded, and its
``full_tensor()`` exactly ``x``; a token sketch of 2 groups fed decode
steps of one row, fewer rows than groups (``one_row_sketch``), bitwise a
``sorted`` engine's; and the smoke arch's steps with the residual stream's
sequence on ``model`` (``seq_residual``) against a single process's.
"""
import dataclasses
import fcntl
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


def smoke(arch: str, swa_window, registry):
    """The smoke arch of ``arch`` from ``registry`` (the port's or JAX's),
    its sliding window set to ``swa_window`` when that is given."""
    overrides = {} if swa_window is None else {"swa_window": swa_window}
    return registry.get_smoke_arch(arch, **overrides)


def _train_batches(cfg) -> list:
    """STEPS TokenStream batches with the modality inputs the arch takes,
    drawn with numpy from a seed a batch: whisper's frames (B, n_frames, D)
    and qwen2-vl's patch embeddings (B, n_patches, D), of order 0.02, and
    its (3, B, S) M-RoPE positions, random in [0, 4·S) so that every stream
    moves the rotation."""
    from repro_torch.data.synthetic import TokenStream
    stream = TokenStream(cfg.vocab, B, SEQ)
    out = []
    for i in range(STEPS):
        host = stream.next()
        rng = np.random.default_rng((7, i))
        if cfg.enc_dec is not None:
            host["frames"] = (rng.standard_normal((B, cfg.enc_dec.n_frames, cfg.d_model))
                              * 0.02).astype(np.float32)
        if cfg.vlm is not None:
            host["vision_embeds"] = (rng.standard_normal((B, cfg.vlm.n_patches, cfg.d_model))
                                     * 0.02).astype(np.float32)
            host["positions"] = rng.integers(0, 4 * SEQ, (3, B, SEQ)).astype(np.int32)
        out.append(host)
    return out


def _prompt(batch: dict) -> dict:
    """A train batch as the prefill takes it: every input but the labels."""
    return {k: v for k, v in batch.items() if k != "labels"}


def _spy_decode(M, on_step):
    """Wrap ``M.decode_step`` (which the serve step calls) so that
    ``on_step(logits)`` sees each step's logits; the returned list holds
    True while the real decode step runs."""
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
    """A DTensor's global value (or a plain tensor) as a numpy copy
    (``full_tensor()`` of a replicated DTensor is its local tensor itself,
    which a later in-place update would change)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().clone().numpy()


def _sketch_record(rec: dict, prefix: str, sk) -> None:
    for name, t in zip(("items", "counts", "errors"), sk.summary):
        rec[f"{prefix}/{name}"] = _whole(t)
    rec[f"{prefix}/buffer"] = _whole(sk.buffer)
    rec[f"{prefix}/n"] = _whole(sk.n)


def _comm_record(comm, moves) -> str:
    return json.dumps({"counts": {str(k): v for k, v in comm.get_comm_counts().items()},
                       "bytes": dict(comm.handed), "calls": comm.calls,
                       "redistributions": moves})


def dense_world(rec: dict) -> None:
    """This file's own world's records: :func:`uneven_heads`,
    :func:`one_row_sketch` and :func:`seq_residual`."""
    uneven_heads(rec)
    one_row_sketch(rec)
    seq_residual(rec)


def _seq_residual(rec: dict, arch: str, strategy: str = "tp") -> None:
    """``arch``'s smoke arch with the residual stream's sequence on
    ``model`` (``PlanOptions.seq_sharded_residual``, the dry run's
    ``--auto`` choice for every large arch but MLA's):
    :func:`_against_one_process`, checked by :func:`assert_seq_residual`."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.sharding.rules import PlanOptions
    rec["seq_residual"] = _against_one_process(
        get_smoke_arch(arch), PlanOptions(seq_sharded_residual=True, moe_strategy=strategy))


def seq_residual(rec: dict) -> None:
    _seq_residual(rec, ARCH)


def seq_residual_moe(rec: dict) -> None:
    _seq_residual(rec, "qwen3-moe-30b-a3b", "ep")


def seq_residual_hybrid(rec: dict) -> None:
    _seq_residual(rec, "zamba2-7b")


def seq_residual_vlm(rec: dict) -> None:
    _seq_residual(rec, "qwen2-vl-72b")


def assert_seq_residual(got, grads_rtol: float = 1e-5, params_lr: float = 0.1,
                        logits_atol: float = 1e-5) -> None:
    """A world's ``seq_residual`` record within ``uneven_whisper``'s
    bounds, or the world's own."""
    seq = json.loads(str(got["seq_residual"]))
    print("seq_residual", seq)
    assert seq["prefill"] <= logits_atol and seq["tokens_equal"]
    assert seq["loss_rel"] <= 1e-5 and seq["grads_rel"] <= grads_rtol
    assert seq["params_lr"] <= params_lr


def uneven_heads(rec: dict) -> None:
    """qwen2.5-14b's 40 heads constrained over 8 ranks (``(1, 8)`` mesh)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.sharding.rules import ShardingPlan

    plan = ShardingPlan(get_arch(ARCH), make_mesh_shape((1, 8), ("data", "model"),
                                                        device_type="cpu"))
    x = torch.randn((2, 16, 40, 128), generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    y = plan.wsc(DTensor.from_local(x, plan.mesh, [Replicate(), Replicate()]), "bshd")
    rec["placement/bshd"] = str(y.placements)
    rec["bshd_local_heads"] = np.int64(y.to_local().shape[2])
    rec["bshd_round_trip"] = np.bool_(torch.equal(y.full_tensor(), x))


def one_row_sketch(rec: dict) -> None:
    """A token sketch of 2 groups (the ``(2, 4)`` mesh's data axis) fed 9
    decode steps of one row, fewer rows than groups (long_500k's decode),
    a flush among them, against a ``sorted`` engine of 2 tenants fed the
    same block decompositions: every leaf of every group, gathered."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.core.parallel import block_decompose
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.sharding.rules import ShardingPlan, placements
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg = get_smoke_arch(ARCH)
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(cfg.sketch, kernel="sorted"))
    mesh = make_mesh_shape((2, 4), ("data", "model"), device_type="cpu")
    plan = ShardingPlan(cfg, mesh)
    engine = SK.token_engine(cfg.sketch, 2, chunk=1, device="cpu")
    sketch = SK.distribute_sketch(plan, engine.init())
    ref = engine.init()
    for t in (5, 7, 5, 9, 5, 7, 3, 5, 7):
        tok = torch.tensor([[t]], dtype=torch.int32)
        sketch = SK.update_token_sketch(
            engine, sketch, S._distribute(tok, mesh, placements(plan.batch_spec(1), mesh)))
        ref = engine.ingest(ref, block_decompose(tok.reshape(-1), 2))
    rec["one_row_sketch_equal"] = np.bool_(sketch.fill == ref.fill and all(
        torch.equal(a.full_tensor(), b) for a, b in zip((*sketch.summary, sketch.buffer, sketch.n),
                                                       (*ref.summary, ref.buffer, ref.n))))


def _against_one_process(cfg, opts=None) -> str:
    """``cfg`` on the ``(2, 4)`` mesh under ``opts``: a prefill, 2 decode
    steps and a train step (lr 5e-4) against the same steps of a single
    process, and the redistributions of the mesh's decode steps that had
    a cache's shape (``decode_moves_cache_shaped``). Every rank runs the
    mesh's steps; rank 0, whose record is kept, alone runs the single
    process's and compares (``"{}"`` on the others)."""
    import torch.distributed as dist
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute

    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.launch.serve import pad_cache
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import PlanOptions, ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    mesh = make_mesh_shape((2, 4), ("data", "model"), device_type="cpu")
    plan, mplan = ShardingPlan(cfg), ShardingPlan(cfg, mesh, opts or PlanOptions())
    host = _train_batches(cfg)[0]
    whole = {k: torch.from_numpy(v) for k, v in host.items()}
    pl = S.batch_shardings(cfg, mplan, whole)
    placed = {k: S._distribute(v, mesh, pl[k]) for k, v in whole.items()}
    prompt = {k: v for k, v in placed.items() if k != "labels"}
    lr_fn = adamw.cosine_schedule(1e-3, 2, 10)

    # the mesh's steps, gathered
    mmodel = S.init_model(cfg, mplan, torch.Generator().manual_seed(5), "cpu")
    mlast, mcache = S.make_prefill_step(cfg, mplan)(mmodel, prompt)
    mcache = S.distribute_cache(cfg, mplan, mcache, SEQ + 2)
    mserve = S.make_serve_step(cfg, mplan, device="cpu")
    g = S.sketch_groups(mplan)
    msk = SK.distribute_sketch(mplan, SK.init_token_sketch(cfg.sketch, g, chunk=max(1, B // g),
                                                           device="cpu"))
    mnxt, mtoks = mlast.argmax(-1).to(torch.int32), []
    cache_shapes = {tuple(t.shape) for t in mcache.values()} | {
        tuple(t.shape[1:]) for t in mcache.values()}
    shaped, real_move = [], redistribute.redistribute_local_tensor

    def move(local, current, target, *args, **kwargs):
        if current.placements != target.placements and tuple(current.shape) in cache_shapes:
            shaped.append(tuple(current.shape))
        return real_move(local, current, target, *args, **kwargs)

    redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = move
    try:
        for i in range(2):
            mnxt, mcache, msk = mserve(mmodel, mcache, mnxt[:, None], SEQ + i, msk)
            mtoks.append(mnxt.full_tensor())
    finally:
        redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = real_move
    mst = S.init_train_state(cfg, torch.Generator(), mplan, device="cpu", model=mmodel)
    mst, mm_ = S.make_train_step(cfg, mplan, lr_fn=lr_fn, device="cpu")(mst, placed)
    mlast = mlast.full_tensor()
    mparams = {n: p.full_tensor() for n, p in mst.params.named_parameters()}
    mmom = {n: mst.opt.m[n].full_tensor() for n in mparams}
    if dist.get_rank() != 0:
        return "{}"

    # the single process's steps
    model = S.init_model(cfg, plan, torch.Generator().manual_seed(5), "cpu")
    last, cache = S.make_prefill_step(cfg, plan)(model, _prompt(whole))
    out = {"prefill": float((mlast - last).abs().max()),
           "decode_moves_cache_shaped": len(shaped)}
    cache = pad_cache(cache, SEQ + 2)
    serve = S.make_serve_step(cfg, plan, device="cpu")
    sk = SK.init_token_sketch(cfg.sketch, 1, chunk=B, device="cpu")
    nxt, same = last.argmax(-1).to(torch.int32), True
    for i in range(2):
        nxt, cache, sk = serve(model, cache, nxt[:, None], SEQ + i, sk)
        same = same and torch.equal(nxt, mtoks[i])
    out["tokens_equal"] = bool(same)
    st = S.init_train_state(cfg, torch.Generator(), plan, device="cpu", model=model)
    st, m = S.make_train_step(cfg, plan, lr_fn=lr_fn, device="cpu")(st, whole)
    params = dict(st.params.named_parameters())
    out["loss_rel"] = abs(float(mm_["loss"]) / float(m["loss"]) - 1)
    out["params_lr"] = max(float((mparams[n] - p).abs().max())
                           for n, p in params.items()) / float(m["lr"])
    out["grads_rel"] = max(float((mmom[n] - st.opt.m[n]).abs().max()
                                 / st.opt.m[n].abs().max())
                           for n in params if not n.endswith("attn.bk"))
    return json.dumps(out)


def uneven_whisper(rec: dict) -> None:
    """whisper-tiny's smoke arch at its published 6 heads (of 32: d 192),
    where ``torch.chunk`` gives the model ranks 2, 2, 2 and 0 heads
    (:func:`_against_one_process`; its key biases, which take no gradient in exact
    arithmetic, left out of the gradient gap)."""
    from repro_torch.configs.registry import get_smoke_arch
    rec["uneven_whisper"] = _against_one_process(
        get_smoke_arch("whisper-tiny", n_heads=6, n_kv_heads=6))


def uneven_mla(rec: dict) -> None:
    """minicpm3-4b's smoke arch at 6 heads in place of its 4, as its
    published 40 on a ``model`` axis of 16 (:func:`_against_one_process`)."""
    from repro_torch.configs.registry import get_smoke_arch
    rec["uneven_mla"] = _against_one_process(
        get_smoke_arch("minicpm3-4b", n_heads=6, n_kv_heads=6))


def ssm_layouts(rec: dict) -> None:
    """``mamba_block`` (a prefill with its state, and its backward) on the
    ``(2, 4)`` mesh against the same block on whole tensors, in the two
    layouts of the scan that mamba2-130m's and zamba2-7b's smoke archs do
    not give (theirs: a rank's heads in one group): 4 groups of 2 heads
    (each rank's heads a whole group) and headdim 128 (2 heads, so
    ``_ssm_spec`` shards P: each rank holds every head's quarter of the
    columns); and the prefill's collectives under ``CommDebugMode``."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import mamba2
    from repro_torch.sharding.rules import ShardingPlan, placements
    from repro_torch.train import steps as S

    mesh = make_mesh_shape((2, 4), ("data", "model"), device_type="cpu")
    base = get_smoke_arch("mamba2-130m")
    for label, ssm in (("whole_groups", dataclasses.replace(base.ssm, n_groups=4)),
                       ("headdim", dataclasses.replace(base.ssm, headdim=128)),
                       ("smoke", base.ssm)):
        cfg = dataclasses.replace(base, ssm=ssm)
        plan = ShardingPlan(cfg, mesh)
        whole = S.init_model(cfg, ShardingPlan(cfg), torch.Generator().manual_seed(3), "cpu")
        model = S.init_model(cfg, plan, torch.Generator().manual_seed(3), "cpu")
        whole.requires_grad_(True)
        model.requires_grad_(True)
        x = torch.randn((B, SEQ, cfg.d_model), generator=torch.Generator().manual_seed(4))
        xd = S._distribute(x, mesh, placements(plan.act_spec("bsd", x.shape), mesh))
        moves = []
        real_move = redistribute.redistribute_local_tensor

        def move(local, current, target, *args, **kwargs):
            if current.placements != target.placements:
                moves.append((str(current.placements), str(target.placements),
                              tuple(current.shape)))
            return real_move(local, current, target, *args, **kwargs)
        redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = move
        try:
            with plan.replicated(), StepCounter() as comm:
                out, (st, tail) = mamba2.mamba_block(model.layers[0].mixer, xd, cfg, plan.wsc,
                                                     return_state=True)
        finally:
            redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = real_move
        want, (st_w, tail_w) = mamba2.mamba_block(whole.layers[0].mixer, x, cfg,
                                                  return_state=True)
        with plan.replicated():
            out.sum().backward()
        want.sum().backward()
        grads = {n: float((p.grad.full_tensor() - dict(whole.named_parameters())[n].grad)
                          .abs().max() / dict(whole.named_parameters())[n].grad.abs().max())
                 for n, p in model.layers[0].mixer.named_parameters(prefix="layers.0.mixer")}
        xs_spec = plan.act_spec("blhp", (B, SEQ, *mamba2.ssm_dims(cfg)[1:2], ssm.headdim))
        rec[f"ssm_layout/{label}"] = json.dumps({
            "blhp": list(map(str, xs_spec)),
            "out": float((out.full_tensor() - want).abs().max() / want.abs().max()),
            "h_final": float((st.full_tensor() - st_w).abs().max() / st_w.abs().max()),
            "conv_tail_equal": bool(torch.equal(tail.full_tensor(), tail_w)),
            "h_final_placements": str(st.placements), "grads_rel": grads,
            "dtensor_out": isinstance(out, DTensor)})
        if label == "smoke":
            rec["comm_prefill"] = _comm_record(comm, moves)


def no_tp_decode(rec: dict) -> None:
    """mamba2-130m's smoke arch under ``no_tp`` (pure data parallelism:
    the weights replicated, the batch over ``data``; the decode caches'
    window channels and state columns still on ``model``), at B 4
    (:func:`_against_one_process`)."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.sharding.rules import PlanOptions
    rec["no_tp_decode"] = _against_one_process(get_smoke_arch("mamba2-130m"),
                                               PlanOptions(no_tp=True))


def ssm_world(rec: dict) -> None:
    """The SSM world's own records: :func:`ssm_layouts`, :func:`no_tp_decode`."""
    ssm_layouts(rec)
    no_tp_decode(rec)


def ranks(arch: str, strategy: str, swa_window, lr: list, extra, weights: str,
          out: str) -> dict:
    """Every rank: the sharded steps; rank 0 saves their results to ``out``."""
    import torch.distributed as dist
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import mamba2, mla
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import PlanOptions, ShardingPlan, placements
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg = smoke(arch, swa_window, registry)
    mesh = make_mesh_shape((2, 4), ("data", "model"), device_type="cpu")
    plan = ShardingPlan(cfg, mesh, PlanOptions(moe_strategy=strategy))
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

    # every dispatch and combine helper's arguments: plain tensors of the
    # rank's own rows, never a DTensor
    seen = {"dtensor_args": 0, "calls": 0, "rows": set()}
    for fn_name in ("dispatch", "_rows", "_sorted_rows", "_gather_rows", "top_k"):
        def spy(*args, _real=getattr(moe, fn_name), **kwargs):
            seen["calls"] += 1
            seen["dtensor_args"] += sum(isinstance(a, DTensor) for a in args)
            seen["rows"].add(int(args[0].shape[0]))
            return _real(*args, **kwargs)
        setattr(moe, fn_name, spy)
    gaps = []
    real_top_k = moe.top_k

    def top_k(probs, k):
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return real_top_k(probs, k)
    moe.top_k = top_k

    params = torch.load(weights)

    def model():
        m = M.build_params(cfg, "cpu")
        m.load_state_dict(params)
        return S.distribute_model(cfg, plan, m)

    hosts = _train_batches(cfg)
    pl = S.batch_shardings(cfg, plan, {k: torch.from_numpy(v) for k, v in hosts[0].items()})
    batches = [{k: S._distribute(torch.from_numpy(v), mesh, pl[k]) for k, v in h.items()}
               for h in hosts]
    for k, t in batches[0].items():
        rec["placement/batch_" + k] = str(t.placements)
    state = S.init_train_state(cfg, torch.Generator(), plan, device="cpu", model=model())
    raw = {}        # the gradients' placements as the backward leaves them

    def seen_grad(name):
        def hook(p):
            raw[name] = str(p.grad.placements)
        return hook
    hooks = [p.register_post_accumulate_grad_hook(seen_grad(n))
             for n, p in state.params.named_parameters()]
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(*lr), device="cpu")
    counts = []
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
    if cfg.moe is not None:
        counts.append(metrics["expert_counts"].clone().numpy())
        rec["aux_loss"] = metrics["moe_aux_loss"].numpy()
        rec["counts_plain"] = np.bool_(not isinstance(metrics["expert_counts"], DTensor))
    state, metrics = step(state, batches[1])
    rec.update(loss2=metrics["loss"].numpy(), grad_norm2=metrics["grad_norm"].numpy(),
               lr2=metrics["lr"].numpy())
    for name, p in state.params.named_parameters():
        rec["param2/" + name] = _whole(p)
    _sketch_record(rec, "train_sketch", state.token_sketch)
    if cfg.moe is not None:
        counts.append(metrics["expert_counts"].clone().numpy())
        rec["expert_counts"] = np.stack(counts)
        rec["aux_loss2"] = metrics["moe_aux_loss"].numpy()
        mine = state_to_numpy(state.expert_sketch)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        rec["expert_sketch_same_on_every_rank"] = np.bool_(all(
            all(np.array_equal(a, b) for a, b in zip(mine, other)) for other in every))
        rec["expert_sketch_plain"] = np.bool_(not isinstance(state.expert_sketch.n, DTensor))
        for i, name in SKETCH_LEAVES:
            rec["expert_sketch/" + name] = mine[i]
    del state

    served = model()
    last, cache = S.make_prefill_step(cfg, plan)(served, _prompt(batches[0]))
    cache = S.distribute_cache(cfg, plan, cache, SEQ + GEN)
    for name, t in cache.items():
        rec["placement/cache_" + name] = str(t.placements)
    cache_shapes = {tuple(t.shape) for t in cache.values()} | {
        tuple(t.shape[1:]) for t in cache.values()}
    serve = S.make_serve_step(cfg, plan, device="cpu")
    groups = S.sketch_groups(plan)
    sketch = SK.distribute_sketch(plan, SK.init_token_sketch(cfg.sketch, groups,
                                                             chunk=B // groups, device="cpu"))
    logits, moves = [], []
    real_decode = M.decode_step
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
        decode_moves = list(moves)
        if cfg.family != "dense" or cfg.mla is not None:
            # the collectives of one layer's MoE FFN (the combine's included),
            # one absorbed MLA decode, one Mamba decode layer (hybrid's
            # first layer is one), one whisper cross-attention decode, or
            # one vlm decode attention, and the redistributions behind them
            moves.clear()
            during.append(True)
            x = S._distribute(torch.randn((B, 1, cfg.d_model), generator=torch.Generator()
                                          .manual_seed(1)),
                              mesh, placements(plan.act_spec("bsd", (B, 1, cfg.d_model)), mesh))
            states = ("ssm_state", "conv")
            before = ({n: cache[n].to_local().clone() for n in states}
                      if cfg.ssm is not None else {})
            with plan.replicated(), torch.no_grad(), StepCounter() as comm:
                if cfg.mla is not None:
                    mla.mla_decode(served.layers[0].attn, x, cfg,
                                   {"c_kv": cache["c_kv"][0], "k_rope": cache["k_rope"][0]},
                                   SEQ + GEN - 1, plan.wsc)
                elif cfg.moe is not None:
                    moe.moe_layer(served.layers[0].moe, x, cfg, plan.wsc)
                elif cfg.ssm is not None:
                    _, st, cv = mamba2.mamba_decode_step(served.layers[0].mixer, x, cfg,
                                                         cache["ssm_state"][0],
                                                         cache["conv"][0], plan.wsc)
                elif cfg.enc_dec is not None:
                    M._decode_cross_attention(served.layers[0], x, cfg, cache["ck"][0],
                                              cache["cv"][0], plan.wsc)
                else:
                    M._decode_self_attention_ro(served.layers[0], x, cfg, cache["k"][0],
                                                cache["v"][0], SEQ + GEN - 1, plan.wsc)
            rec["comm"] = _comm_record(comm, list(moves))
            if cfg.ssm is not None:
                # the step wrote layer 0 of the stacked cache's own shards (and
                # nothing else), and the returned state and window are them
                rec["state_written_in_place"] = np.bool_(all(
                    not torch.equal(cache[n].to_local()[0], before[n][0])
                    and torch.equal(cache[n].to_local()[1:], before[n][1:])
                    and torch.equal(cache[n].to_local()[0], t.to_local())
                    for n, t in zip(states, (st, cv))))
    finally:
        during.clear()
        M.decode_step = real_decode
        redistribute.redistribute_local_tensor = dispatch.redistribute_local_tensor = real_move
    rec["prefill_last"] = _whole(last)
    rec["decode_logits"] = torch.stack(logits, 1).numpy()
    rec["decoded"] = torch.stack(emitted, 1).numpy()
    rec["decode_moves"] = np.int64(len(decode_moves))
    rec["decode_moves_cache_shaped"] = np.int64(sum(m[2] in cache_shapes
                                                    for m in decode_moves))
    _sketch_record(rec, "serve_sketch", sketch)
    rec["dispatch"] = json.dumps({"dtensor_args": seen["dtensor_args"], "calls": seen["calls"],
                                  "rows": sorted(seen["rows"])})
    rec["min_topk_gap"] = np.float64(min(gaps) if gaps else np.inf)
    if extra is not None:
        globals()[extra](rec)
    if dist.get_rank() == 0:
        np.savez(out, **rec)
    return {"world": dist.get_world_size()}


def check(tmp_path, monkeypatch, arch: str, strategy: str, swa_window, lr: tuple,
          extra=None, grads_rtol: float = 1e-5, params_lr: float = 0.1,
          logits_atol: float = 1e-5) -> dict:
    """Run :func:`ranks` in a world of 8 and hold what rank 0 saw against the
    port's single-process steps and JAX's (see the module docstring).
    ``lr`` is the ``cosine_schedule(base, warmup, total)`` of both
    packages' steps; ``extra`` names a function of this module that adds a
    world's own records on every rank. ``grads_rtol`` (the gradients'
    bound beside the port's, of each leaf's largest), ``params_lr`` (the
    parameters' bound, in units of the step's lr) and ``logits_atol`` (the
    prefill's and decode's logits) are the module docstring's unless a
    world states its own. Returns rank 0's record and
    the measured gaps for the file's own checks."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.optim import adamw as jadamw
    from repro.sharding.rules import ShardingPlan as JShardingPlan
    from repro.train import steps as JS
    from repro_torch.configs import registry
    from repro_torch.core.parallel import block_decompose
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg, jcfg = smoke(arch, swa_window, registry), smoke(arch, swa_window, jregistry)
    jstate = JS.init_train_state(jcfg, jax.random.PRNGKey(0), JShardingPlan(jcfg, None))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jstate.params))
    torch.save(params, tmp_path / "weights.pt")
    out = tmp_path / "ranks.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans"),
               PYTHONPATH=os.pathsep.join([str(Path(__file__).resolve().parents[1] / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    env.pop("REPRO_TORCH_PLAN_FILE", None)
    # one world of 8 ranks at a time: under pytest-xdist the worlds of the
    # other files wait on a lock in pytest's base temp dir (the parent of
    # each worker's), so they do not crowd the cores that every other
    # test, timing gates included, is running on
    with open(tmp_path.parents[1] / "sharded_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run([sys.executable, __file__, arch, strategy,
                               json.dumps(swa_window), json.dumps(list(lr)), json.dumps(extra),
                               str(tmp_path / "weights.pt"), str(out)],
                              env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"world": 8}
    got = dict(np.load(out))
    plan = ShardingPlan(cfg)
    is_moe = cfg.moe is not None

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
    step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(*lr), device="cpu")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in hosts[0].items()})
    after1 = {n: (p.detach().clone().numpy(), state.opt.m[n].clone().numpy())
              for n, p in state.params.named_parameters()}
    counts = [m["expert_counts"].clone().numpy()] if is_moe else []
    state, m2 = step(state, {k: torch.from_numpy(v) for k, v in hosts[1].items()})
    after2 = {n: p.detach().numpy() for n, p in state.params.named_parameters()}
    if is_moe:
        counts.append(m2["expert_counts"].clone().numpy())
    jstep = jax.jit(JS.make_train_step(jcfg, JShardingPlan(jcfg, None),
                                       lr_fn=jadamw.cosine_schedule(*lr)))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in hosts[0].items()})
    jlm_head = np.asarray(jstate.params["lm_head"])
    jmom = params_from_jax(cfg, jax.tree.map(np.asarray, jstate.opt.m))
    jstate, jm2 = jstep(jstate, {k: jnp.asarray(v) for k, v in hosts[1].items()})

    def rel(a, b):
        return abs(float(a) / float(b) - 1)

    # a key bias of an attention without RoPE (whisper's) takes no gradient
    # in exact arithmetic: a softmax does not see a shift that every key
    # shares, and each package's f32 sums leave noise of ~1e-11 there. Such
    # a leaf is held against the largest gradient of the reference model
    # (its own largest is that noise)
    zero = {n for n in after1 if cfg.enc_dec is not None and n.endswith("attn.bk")}

    def leaf_gap(n, a, ref: dict):
        b = ref[n]
        scale = max(np.abs(t).max() for t in ref.values()) if n in zero else np.abs(b).max()
        return float(np.abs(a - b).max() / max(scale, 1e-30))

    moms = {n: mom for n, (_, mom) in after1.items()}
    jmoms = {n: t.numpy() for n, t in jmom.items()}

    gaps = {"loss_rel": rel(got["loss"], m["loss"]),
            "loss_vs_jax": abs(float(got["loss"]) - float(jm["loss"])),
            "grad_norm_rel": rel(got["grad_norm"], m["grad_norm"]),
            "grad_norm_rel_vs_jax": rel(got["grad_norm"], jm["grad_norm"]),
            "grads_rel": max(leaf_gap(n, got["m/" + n], moms) for n in after1),
            "grads_rel_leaf": max(after1, key=lambda n: leaf_gap(n, got["m/" + n], moms)),
            "grads_rel_vs_jax": max(leaf_gap(n, got["m/" + n], jmoms) for n in after1),
            "zero_grad_leaves": sorted(zero),
            "loss2_rel": rel(got["loss2"], m2["loss"]),
            "loss2_vs_jax": abs(float(got["loss2"]) - float(jm2["loss"])),
            "grad_norm2_rel": rel(got["grad_norm2"], m2["grad_norm"]),
            "lr": float(m["lr"]), "lr2": float(m2["lr"]),
            "params": max(float(np.abs(got["param/" + n] - p).max())
                          for n, (p, _) in after1.items()),
            "params2": max(float(np.abs(got["param2/" + n] - p).max())
                           for n, p in after2.items()),
            "lm_head_vs_jax": float(np.abs(got["param/lm_head"] - jlm_head).max()),
            "grads_in_other_placements": sorted(n for n in after1
                                                if got["raw_grad/" + n] != got["placement/" + n]),
            "min_topk_gap": float(got["min_topk_gap"])}
    if is_moe:
        gaps["aux_loss_rel"] = max(rel(got["aux_loss"], m["moe_aux_loss"]),
                                   rel(got["aux_loss2"], m2["moe_aux_loss"]))
        gaps["aux_loss_rel_vs_jax"] = max(rel(got["aux_loss"], jm["moe_aux_loss"]),
                                          rel(got["aux_loss2"], jm2["moe_aux_loss"]))
    print(json.dumps({"arch": arch, "moe_strategy": strategy, "train_gaps": gaps}))
    assert gaps["loss_rel"] <= 1e-5 and gaps["loss_vs_jax"] < 1e-3
    assert gaps["grad_norm_rel"] <= 1e-5 and gaps["grad_norm_rel_vs_jax"] <= 1e-5
    assert gaps["grads_rel"] <= grads_rtol and gaps["grads_rel_vs_jax"] <= 1e-4
    assert gaps["loss2_rel"] <= 1e-5 and gaps["loss2_vs_jax"] < 1e-3
    assert gaps["grad_norm2_rel"] <= 1e-5
    assert float(got["lr"]) == gaps["lr"] and float(got["lr2"]) == gaps["lr2"]
    assert gaps["params"] <= params_lr * gaps["lr"]
    assert gaps["params2"] <= params_lr * gaps["lr2"]
    assert gaps["lm_head_vs_jax"] < 5e-2
    if is_moe:
        assert gaps["aux_loss_rel"] <= 1e-5 and gaps["aux_loss_rel_vs_jax"] <= 1e-5
    # the backward left some gradients in other placements (a Partial sum),
    # and the step put each back in its parameter's before the update
    assert gaps["grads_in_other_placements"]

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

    if is_moe:
        # the global counts and the expert sketch: plain, the same on every
        # rank, a sorted expert engine's fed the counts
        np.testing.assert_array_equal(got["expert_counts"], np.stack(counts))
        assert got["expert_counts"].sum(1).tolist() == [B * SEQ * cfg.moe.top_k
                                                        * cfg.n_layers] * STEPS
        assert bool(got["counts_plain"]) and bool(got["expert_sketch_plain"])
        assert bool(got["expert_sketch_same_on_every_rank"])
        exp_engine = SK.expert_engine(sorted_sk, device="cpu")
        ref = SK.init_expert_sketch(sorted_sk, device="cpu")
        for row in counts:
            ref = SK.update_expert_sketch(exp_engine, ref, torch.from_numpy(row))
        want = state_to_numpy(ref)
        single = state_to_numpy(state.expert_sketch)
        for i, name in SKETCH_LEAVES:
            np.testing.assert_array_equal(got["expert_sketch/" + name], want[i], err_msg=name)
            np.testing.assert_array_equal(single[i], want[i], err_msg=name)
        # the dispatch and combine ran on each rank's 2 of the 4 rows, on
        # plain tensors
        seen = json.loads(str(got["dispatch"]))
        gaps["dispatch"] = seen
        assert seen["calls"] > 0 and seen["dtensor_args"] == 0
        assert seen["rows"] == [B // 2], seen

    # prefill and 4 decode steps against the single-process steps
    model.load_state_dict(params)              # the train steps moved the weights
    last, cache = S.make_prefill_step(cfg, plan)(
        model, {k: torch.from_numpy(v) for k, v in _prompt(hosts[0]).items()})
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
    if "comm" in got:
        gaps["comm"] = json.loads(str(got["comm"]))
    print(json.dumps({"arch": arch, "moe_strategy": strategy, "gaps": gaps}))
    assert gaps["prefill_last_logits"] <= logits_atol
    assert gaps["decode_logits"] <= logits_atol
    np.testing.assert_array_equal(got["decoded"], torch.stack(emitted, 1).numpy())
    # the decode redistributed tensors (the new token's q/k/v or latent, the
    # FSDP weights, the experts' buffers), never one of a cache's shape
    assert gaps["decode_moves"] > 0 and gaps["decode_moves_cache_shaped"] == 0
    engine = SK.token_engine(sorted_sk, 2, chunk=B // 2, device="cpu")
    ref = engine.init()
    for i in range(GEN):
        ref = engine.ingest(ref, block_decompose(torch.from_numpy(got["decoded"][:, i]), 2))
    want = state_to_numpy(ref)
    for i, name in SKETCH_LEAVES:
        np.testing.assert_array_equal(got["serve_sketch/" + name], want[i], err_msg=name)
    return {"got": got, "gaps": gaps}


def test_sharded_steps_match_single_process_and_jax(tmp_path, monkeypatch):
    out = check(tmp_path, monkeypatch, ARCH, "tp", None, LR, extra="dense_world")
    got, gaps = out["got"], out["gaps"]
    assert got["placement/layers.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"  # FSDP, TP
    assert got["placement/cache_k"] == "(Shard(dim=1), Shard(dim=2))"  # batch, sequence
    assert got["placement/bshd"] == "(Shard(dim=0), Shard(dim=2))"
    assert int(got["bshd_local_heads"]) == 5
    assert bool(got["bshd_round_trip"])
    assert bool(got["one_row_sketch_equal"])
    assert_seq_residual(got)


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks
    arch_, strategy_, swa_, lr_, extra_, weights_, out_ = sys.argv[1:8]
    print(json.dumps(spawn_ranks(8, ranks, arch_, strategy_, json.loads(swa_), json.loads(lr_),
                                 json.loads(extra_), weights_, out_)))
