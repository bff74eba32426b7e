"""Multi-pod dry run: every (arch × shape × mesh) cell's step, counted.

The counterpart of ``repro.launch.dryrun``. JAX lowers and compiles each
cell's real jitted step against ShapeDtypeStructs on 256 (512) forced host
devices. Eager torch has nothing to lower, so here each cell's REAL step
(``train/steps.py``'s train / prefill / serve step) runs once on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage) placed as
DTensors on the production mesh of a one-process ``"fake"`` world of 256
ranks (512 with ``pod``), under ``launch/hlo_analysis.analyze``, which
counts one rank's FLOPs, bytes, collectives and memory. Records go to
``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` in JAX's schema
(``.error.json`` on failure). Failures here are sharding bugs in the port —
the matrix must be green.

The state and the inputs are made under ``FakeTensorMode`` and placed by
the steps' own shardings (``distribute_model``/``init_train_state``,
``batch_shardings``, ``cache_shardings``, ``sketch.distribute_sketch``);
the step runs with the mode inactive (fake tensors carry their mode;
DTensor's sharding propagation of some ops, and its local shapes, need
real scalars where the mode would give symbolic ones). A plain tensor
the model makes from shapes (RoPE angles, masks) is real and small.

What the record's timing fields mean here: ``lower_s`` is the time to
build the state, the inputs and the step; ``compile_s`` the time of the
one fake step under the counting modes; ``xla_cost_raw`` the FLOPs and
bytes of the ops at their global shapes (``analyze``'s ``global``).

The sketch kernels are ctypes wrappers that need a real tensor's pointer,
so the engines take the plain path that JAX's dry run takes on its host
devices (``plan.static_impl(..., on_cuda=False)``): the record's
``cfg_overrides`` names it (``sketch_kernel``).

``--auto`` applies JAX's per-arch policy to ``--all``'s cells and, unlike
JAX's CLI, to a single cell too.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing] [--auto]
  (--device cpu: a cpu mesh of fake CPU tensors, where no card is)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding.rules import PlanOptions, ShardingPlan, placements

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# small archs first so pipeline bugs surface fast (JAX's --all order)
ORDER = ["mamba2-130m", "whisper-tiny", "qwen2.5-14b", "minicpm3-4b", "mixtral-8x7b",
         "qwen3-moe-30b-a3b", "yi-34b", "zamba2-7b", "qwen2-vl-72b", "qwen1.5-110b"]


def _cell_path(arch, shape, mesh_kind, tag=""):
    suffix = f"__{tag}" if tag else ""
    return RESULTS / f"{arch}__{shape}__{mesh_kind}{suffix}.json"


def fake_world(n: int) -> None:
    """A default group of ``n`` ranks of the ``"fake"`` backend (this
    process is rank 0; collectives move nothing). An existing fake group of
    another size is replaced; any other group is left to the mesh, which
    refuses one of the wrong size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n or dist.get_backend() != "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _fake(tree, device):
    """Fake tensors of ``tree``'s (``meta``) shapes and dtypes on ``device``;
    other leaves as they are. Call under ``FakeTensorMode``."""
    from torch.utils import _pytree
    return _pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                            if isinstance(t, torch.Tensor) else t, tree)


def auto_policy(arch: str, shape: str, mesh_kind: str, overrides: dict):
    """JAX's ``--auto``: the per-arch policy distilled from §Perf (band
    schedule, tile remat, seq-sharded residual, local-dispatch EP MoE;
    nested remat for big dense archs; pure DP for <1B-param archs) ->
    (opts, overrides, schedule). JAX's policy also donates the step's
    state, which the port's steps always update in place."""
    cfg = get_arch(arch)
    n_dev = 512 if mesh_kind == "pod" else 256
    small = M.param_count(cfg) < 1_000_000_000
    # pure DP only when the batch can actually occupy the whole mesh (else
    # the model axis idles)
    no_tp = small and SHAPES[shape].global_batch % n_dev == 0
    opts = PlanOptions(
        moe_strategy="ep" if cfg.moe is not None and cfg.moe.n_experts % 16 == 0 else "tp",
        # MLA internals are not seq-constrained yet — seqres regressed
        # minicpm3 25× (§Perf note)
        seq_sharded_residual=not small and cfg.mla is None,
        no_tp=no_tp)
    over = dict(overrides)
    over["attn_remat_tiles"] = cfg.mla is None
    over["embed_rows_local"] = not small
    if cfg.family in ("dense", "vlm") and cfg.moe is None and cfg.mla is None:
        over["remat"] = "nested:8"
    # gradient-exact head padding when heads don't divide the model axis but
    # one extra per group does
    if cfg.mla is None and cfg.family in ("dense", "vlm") and cfg.n_heads % 16 != 0:
        g = cfg.n_heads // cfg.n_kv_heads
        if (cfg.n_kv_heads * (g + 1)) % 16 == 0:
            over["q_head_pad"] = 1
    return opts, over, "band"


def lower_cell(arch_name: str, shape_name: str, mesh_kind: str,
               opts: PlanOptions = PlanOptions(), schedule: str = "masked",
               tag: str = "", cfg_overrides=None, device: str = "cuda"):
    from repro_torch.plan.plan import static_impl

    cfg = get_arch(arch_name)
    overrides = {"sketch_kernel": static_impl("flush", cfg.sketch.k_counters, on_cuda=False),
                 **(cfg_overrides or {})}
    cfg = dataclasses.replace(
        cfg, **{k: v for k, v in overrides.items() if k != "sketch_kernel"},
        sketch=dataclasses.replace(cfg.sketch, kernel=overrides["sketch_kernel"]))
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return {"skipped": "pure full-attention arch (DESIGN.md §4)",
                "arch": arch_name, "shape": shape_name, "mesh": mesh_kind}
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: --device cuda needs a CUDA torch and a card; "
                           "pass --device cpu for a cpu mesh")
    multi_pod = mesh_kind == "pod"
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=torch.device(device).type)
    counted = count_step(cfg, shape, ShardingPlan(cfg, mesh, opts), schedule=schedule,
                         device=device)
    return {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
            "cfg_overrides": overrides, **counted}


def count_step(cfg, shape, plan: ShardingPlan, *, schedule: str = "masked",
               device: str = "cuda") -> dict:
    """Build ``shape``'s step of ``cfg`` (a ``ShapeConfig``) on ``plan``'s
    mesh from fake tensors and count it once (module docstring): every
    field of the record but the cell's names, its tag and ``cfg_overrides``.
    ``donate`` is what the port does, not an option: a train step updates
    its state and a serve step its cache and sketch in place (JAX's
    ``donate_argnums``), which ``memory["alias_bytes"]`` counts; a prefill
    step updates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    mesh = plan.mesh
    t0 = time.time()
    b = shape.global_batch
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = S.distribute_model(cfg, plan, M.build_params(cfg, device))
        if shape.kind == "decode":
            dec = I.decode_input_shapes(cfg, shape)
            cache_pl = S.cache_shardings(cfg, plan, dec["cache"])
            cache = {n: S._distribute(t, mesh, cache_pl[n])
                     for n, t in _fake(dec["cache"], device).items()}
            tokens = S._distribute(_fake(dec["tokens"], device), mesh,
                                   placements(plan.batch_spec(b), mesh))
            g = S.sketch_groups(plan)
            # decode payload is B tokens/step — size buffer slots to it
            sketch = SK.distribute_sketch(plan, _fake(SK.token_sketch_shapes(
                cfg.sketch, g, chunk=max(1, b // g), device=device), device))
        else:
            batch_shapes = (I.train_batch_shapes if shape.kind == "train"
                            else I.prefill_batch_shapes)(cfg, shape)
            pl = S.batch_shardings(cfg, plan, batch_shapes)
            batch = {k: S._distribute(t, mesh, pl[k])
                     for k, t in _fake(batch_shapes, device).items()}
            if shape.kind == "train":
                state = S.init_train_state(cfg, torch.Generator(), plan, device=device,
                                           model=model)
    if shape.kind == "train":
        step = S.make_train_step(cfg, plan, schedule=schedule, device=device)
        args = (state, batch)
        tokens_per_step, flops_factor = b * shape.seq_len, 6
    elif shape.kind == "prefill":
        step = S.make_prefill_step(cfg, plan, schedule=schedule)
        args = (model, batch)
        tokens_per_step, flops_factor = b * shape.seq_len, 2
    else:
        step = S.make_serve_step(cfg, plan, device=device)
        # the token at the cache's last position: the step attends over it all
        args = (model, cache, tokens, shape.seq_len - 1, sketch)
        tokens_per_step, flops_factor = b, 2
    t_lower = time.time() - t0

    t0 = time.time()
    ana = HA.analyze(step, *args)
    t_compile = time.time() - t0

    n_dev = mesh.size()
    colls = ana["collectives"]
    wire = sum(c["wire_bytes"] for c in colls.values())
    flops_dev, bytes_dev = ana["flops"], ana["bytes"]
    n_params = M.param_count(cfg)
    n_active = M.param_count(cfg, active_only=True)
    model_flops = flops_factor * n_active * tokens_per_step
    return {
        "kind": shape.kind, "devices": int(n_dev), "schedule": schedule,
        "donate": shape.kind != "prefill",
        "moe_strategy": plan.opts.moe_strategy, "xla_cost_raw": ana["global"],
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "collectives": colls, "wire_bytes_per_device": wire,
        "memory": ana["memory"],
        "n_params": n_params, "n_active_params": n_active,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / n_dev,
        "useful_flops_ratio": (model_flops / n_dev) / flops_dev if flops_dev else None,
        "roofline": HA.roofline_terms(flops_dev, bytes_dev, wire),
    }


def run_cell(arch, shape, mesh_kind, skip_existing=False, tag="",
             opts=PlanOptions(), schedule="masked", cfg_overrides=None, device="cuda"):
    out = _cell_path(arch, shape, mesh_kind, tag)
    if skip_existing and out.exists():
        print(f"[skip-existing] {out.name}")
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        rec = lower_cell(arch, shape, mesh_kind, opts=opts, schedule=schedule,
                         tag=tag, cfg_overrides=cfg_overrides, device=device)
        out.write_text(json.dumps(rec, indent=1))
        err_file = out.with_suffix(".error.json")
        if err_file.exists():
            err_file.unlink()
        status = "SKIP" if "skipped" in rec else \
            f"ok lower={rec['lower_s']}s compile={rec['compile_s']}s " \
            f"bottleneck={rec['roofline']['bottleneck']}"
        print(f"[{arch} × {shape} × {mesh_kind}{('×'+tag) if tag else ''}] {status}",
              flush=True)
        return True
    except Exception as e:
        # a cell's failure is a record of the matrix, not the end of the run
        err = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:],
               # the port's frames, which the traceback's tail (torch's) may cut
               "frames": [f"{f.filename}:{f.lineno} {f.name}"
                          for f in traceback.extract_tb(e.__traceback__)
                          if "repro_torch" in f.filename]}
        out.with_suffix(".error.json").write_text(json.dumps(err, indent=1))
        print(f"[{arch} × {shape} × {mesh_kind}] FAIL {type(e).__name__}: "
              f"{str(e)[:400]}", flush=True)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--moe-strategy", default="tp", choices=["tp", "ep"])
    ap.add_argument("--seq-sharded-residual", action="store_true")
    ap.add_argument("--no-tp", action="store_true")
    ap.add_argument("--schedule", default="masked", choices=["masked", "band"])
    ap.add_argument("--auto", action="store_true",
                    help="per-arch optimized policy distilled from §Perf: "
                         "band schedule, tile remat, seq-sharded residual, "
                         "local-dispatch EP MoE; nested remat for "
                         "big dense archs; pure-DP for <1B-param archs")
    ap.add_argument("--attn-remat-tiles", action="store_true")
    ap.add_argument("--remat", default=None,
                    help="override cfg.remat, e.g. nested:8")
    ap.add_argument("--embed-rows-local", action="store_true")
    ap.add_argument("--q-head-pad", type=int, default=0,
                    help="zero-init q heads added per KV group (§Perf)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device and the mesh's device type")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all's cells run at once, each worker a process of its "
                         "own (the matrix is hours of one core)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.attn_remat_tiles:
        overrides["attn_remat_tiles"] = True
    if args.remat:
        overrides["remat"] = args.remat
    if args.embed_rows_local:
        overrides["embed_rows_local"] = True
    if args.q_head_pad:
        overrides["q_head_pad"] = args.q_head_pad

    meshes = ["single", "pod"] if args.mesh == "both" else [args.mesh]
    opts = PlanOptions(moe_strategy=args.moe_strategy,
                       seq_sharded_residual=args.seq_sharded_residual,
                       no_tp=args.no_tp)

    def cell(arch, shape, mesh_kind):
        """run_cell's arguments for one cell."""
        c_opts, c_over, c_sched = opts, overrides, args.schedule
        if args.auto:
            c_opts, c_over, c_sched = auto_policy(arch, shape, mesh_kind, overrides)
        return (arch, shape, mesh_kind), dict(
            skip_existing=args.skip_existing, tag=args.tag, opts=c_opts, schedule=c_sched,
            cfg_overrides=c_over, device=args.device)

    if args.all:
        t0 = time.time()
        cells = [cell(arch, shape, mesh_kind) for mesh_kind in meshes
                 for arch in ORDER for shape in SHAPES]
        if args.jobs > 1:
            import concurrent.futures
            import multiprocessing
            with concurrent.futures.ProcessPoolExecutor(
                    args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
                oks = list(pool.map(_run_cell, cells))
        else:
            oks = [_run_cell(c) for c in cells]
        n_ok = sum(oks)
        print(f"done: {n_ok} ok, {len(oks) - n_ok} failed in {time.time() - t0:.1f}s")
        raise SystemExit(1 if n_ok < len(oks) else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    ok = all([_run_cell(cell(args.arch, args.shape, mesh_kind)) for mesh_kind in meshes])
    raise SystemExit(0 if ok else 1)


def _run_cell(cell) -> bool:
    """run_cell of ``((arch, shape, mesh_kind), keyword arguments)``."""
    names, kwargs = cell
    return run_cell(*names, **kwargs)


if __name__ == "__main__":
    main()
