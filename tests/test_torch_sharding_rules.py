"""The port's mesh resolver against the JAX package's, on strings and shapes.

``models/model.py:param_axes`` against ``repro.models.model.param_axes``
leaf for leaf; ``sharding/rules.py``'s ``param_spec``, ``act_spec``,
``_cache_seq_axes``, ``batch_spec`` and ``_ssm_spec`` against
``repro.sharding.rules``' with ``==`` (every spec as the tuple of its
``PartitionSpec``), for every arch of the registry, three mesh shapes
and every ``PlanOptions`` variant; the values JAX's own tests assert; and
:func:`placements`. No process group: the meshes here are stand-ins that
carry only the names and sizes a plan reads.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_arch as jax_arch
from repro.launch.inputs import decode_input_shapes as jax_decode_shapes
from repro.models import model as JM
from repro.sharding.rules import PlanOptions as JPlanOptions
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch.inputs import decode_input_shapes
from repro_torch.models import model as M
from repro_torch.models.convert import jax_path, stack_params
from repro_torch.sharding.rules import PlanOptions, ShardingPlan, placements
from repro_torch.train import steps as S

ARCHS = list(JARCHS)
AXIS_SIZES = {"dm16": {"data": 16, "model": 16},
              "pdm": {"pod": 2, "data": 16, "model": 16},
              "dm24": {"data": 2, "model": 4}}
OPTIONS = {"default": {}, "ep": {"moe_strategy": "ep"}, "fsdp_over_pod": {"fsdp_over_pod": True},
           "no_tp": {"no_tp": True}}


class _JaxMesh:
    """What ``repro.sharding.rules.ShardingPlan`` reads of a mesh."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = type("devices", (), {"shape": tuple(sizes.values())})


class _Mesh:
    """What the port's ``ShardingPlan`` and ``placements`` read of a mesh."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _plans(arch, sizes, options):
    jcfg, cfg = jax_arch(arch), get_arch(arch)
    return (JShardingPlan(jcfg, _JaxMesh(AXIS_SIZES[sizes]), JPlanOptions(**OPTIONS[options])),
            ShardingPlan(cfg, _Mesh(AXIS_SIZES[sizes]), PlanOptions(**OPTIONS[options])))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    cfg = jax_arch(arch)
    return JM.param_axes(cfg), JM.param_shapes(cfg)


@functools.lru_cache(maxsize=None)
def _port_tree(arch):
    cfg = get_arch(arch)
    return M.param_axes(cfg), stack_params(cfg, M.param_shapes(cfg))


def _leaves(tree, prefix=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, prefix + name + "/")
        else:
            yield prefix + name, leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_jax(arch):
    assert M.param_axes(get_arch(arch)) == _jax_tree(arch)[0]


def test_param_axes_embed_rows_local_equal_jax():
    jcfg = dataclasses.replace(jax_arch("qwen2.5-14b"), embed_rows_local=True)
    cfg = dataclasses.replace(get_arch("qwen2.5-14b"), embed_rows_local=True)
    axes = M.param_axes(cfg)
    assert axes == JM.param_axes(jcfg)
    assert axes["embed"] == "vocab_rows,embed_tp"


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_axes_cover_every_parameter(arch):
    cfg = get_arch(arch)
    shapes = M.param_shapes(cfg)
    axes = M.state_dict_axes(cfg)
    assert axes.keys() == shapes.keys()
    assert all(len(axes[n].split(",")) == t.dim() for n, t in shapes.items())


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("sizes", list(AXIS_SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_jax(arch, sizes, options):
    jplan, plan = _plans(arch, sizes, options)
    jaxes, jshapes = _jax_tree(arch)
    axes, shapes = _port_tree(arch)
    jshapes, shapes = dict(_leaves(jshapes)), dict(_leaves(shapes))
    for name, axes_str in _leaves(axes):
        shape = tuple(shapes[name].shape)
        assert shape == tuple(jshapes[name].shape), name
        want = tuple(jplan.param_spec(axes_str, shape))
        assert plan.param_spec(axes_str, shape) == want, (name, axes_str, shape)
    # the state_dict view: a layer's tensor drops the stacked leaf's
    # 'layers' dim, which no mesh axis ever takes, and nothing else
    cfg = get_arch(arch)
    specs = plan.param_specs(M.state_dict_axes(cfg), M.param_shapes(cfg))
    for name, spec in specs.items():
        group, leaf, layer = jax_path(cfg, name)
        key = leaf if group is None else f"{group}/{leaf}"
        stacked = tuple(jplan.param_spec(dict(_leaves(jaxes))[key], tuple(jshapes[key].shape)))
        assert spec == (stacked[1:] if layer is not None else stacked), (name, spec, stacked)


def _act_shapes(cfg, shape):
    """One shape a code at the cell ``shape`` (B = its global batch)."""
    b, s = shape.global_batch, shape.seq_len
    e = cfg.moe.n_experts if cfg.moe is not None else 8
    ssm_heads = (cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim, cfg.ssm.headdim) \
        if cfg.ssm is not None else (cfg.n_q_heads, cfg.hd)
    return {"bsd": (b, s, cfg.d_model), "bsv": (b, s, cfg.vocab),
            "bshd": (b, s, cfg.n_q_heads, cfg.hd), "bskvh": (b, s, cfg.n_kv_heads, cfg.hd),
            "btf": (b, s, cfg.d_ff), "becd": (b, e, 64, cfg.d_model),
            "becf": (b, e, 64, cfg.d_ff), "blhp": (b, s, *ssm_heads),
            "bskh": (b, s, cfg.n_kv_heads, cfg.hd)}


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("sizes", list(AXIS_SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_and_cache_specs_equal_jax(arch, sizes, options):
    jplan, plan = _plans(arch, sizes, options)
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    for cell in SHAPES:
        shape = SHAPES[cell]
        for code, act in _act_shapes(cfg, shape).items():
            assert plan.act_spec(code, act) == tuple(jplan.act_spec(code, act)), (cell, code)
        b = shape.global_batch
        assert plan.batch_spec(b) == tuple(jplan.batch_spec(b)), cell
        cache = decode_input_shapes(cfg, shape)["cache"]
        jcache = jax_decode_shapes(jcfg, JSHAPES[cell])["cache"]
        assert {n: tuple(t.shape) for n, t in cache.items()} == \
            {n: tuple(t.shape) for n, t in jcache.items()}
        for name, t in cache.items():
            lead = (t.shape[1],) + tuple(t.shape[2:])
            assert plan._cache_seq_axes(lead) == jplan._cache_seq_axes(lead), (cell, name)
            assert plan._cache_seq_axes((t.shape[1],), seq_dim=t.shape[2]) == \
                jplan._cache_seq_axes((t.shape[1],), seq_dim=t.shape[2]), (cell, name)
        ssm = _act_shapes(cfg, shape)["blhp"]
        bt = plan._batch(b)
        assert bt == jplan._batch(b)
        assert plan._ssm_spec(ssm, bt) == tuple(jplan._ssm_spec(ssm, bt)), cell


def test_jax_tests_literal_values():
    """tests/test_sharding_dist.py's test_param_spec_resolution and
    test_moe_param_spec_strategies, on the port."""
    plan = ShardingPlan(get_arch("qwen1.5-110b"), None)
    plan.axis_sizes = {"pod": 2, "data": 16, "model": 16}
    plan.has_pod = True
    plan.batch_axes = ("pod", "data")
    assert plan.param_spec("embed,ff", (8192, 49152)) == ("data", "model")
    assert plan.param_spec("vocab,embed", (152064, 8192)) == ("model", "data")
    assert plan.param_spec("norm", (8192,)) == (None,)
    assert plan.param_spec("ff,embed", (49155, 8192)) == (None, "data")
    for strat, want in [("tp", (None, "data", "model")), ("ep", ("model", "data", None))]:
        plan = ShardingPlan(get_arch("qwen3-moe-30b-a3b"), None,
                            PlanOptions(moe_strategy=strat))
        plan.axis_sizes = {"data": 16, "model": 16}
        assert plan.param_spec("experts,embed,expert_ff", (128, 2048, 768)) == want


def test_mesh_none_is_the_single_process_plan():
    cfg = get_arch("qwen2.5-14b")
    plan = ShardingPlan(cfg)
    x = torch.zeros(2, 3, 4)
    assert plan.axis_sizes == {} and plan.batch_axes == ("data",)
    assert plan.wsc(x, "bsd") is x
    assert plan.param_spec("embed,ff", (5120, 13824)) == ()
    assert S.sketch_groups(plan) == 1


@pytest.mark.parametrize("spec,want", [
    ((), [Replicate(), Replicate(), Replicate()]),
    (("data", None), [Replicate(), Shard(0), Replicate()]),
    ((None, "model", None), [Replicate(), Replicate(), Shard(1)]),
    (("data", "model"), [Replicate(), Shard(0), Shard(1)]),
    ((("pod", "data"), None, "model"), [Shard(0), Shard(0), Shard(2)]),
    ((None, ("data", "model")), [Replicate(), Shard(1), Shard(1)]),
])
def test_placements(spec, want):
    assert placements(spec, _Mesh({"pod": 2, "data": 2, "model": 2})) == want


def test_state_batch_and_cache_placements():
    """qwen2.5-14b on a (2, 4) data × model mesh: what the gloo test and
    chip_smoke's phase 16 place."""
    cfg = get_arch("qwen2.5-14b")
    plan = ShardingPlan(cfg, _Mesh({"data": 2, "model": 4}))
    sh = S.train_state_shardings(cfg, plan)
    assert sh.params["layers.0.attn.wq"] == [Shard(0), Shard(1)]       # embed FSDP, heads TP
    assert sh.params["embed"] == [Shard(1), Shard(0)]                  # vocab TP, embed FSDP
    assert sh.params["final_norm.scale"] == [Replicate(), Replicate()]
    assert sh.opt.master is sh.params and sh.opt.count == [Replicate(), Replicate()]
    assert sh.token_sketch.buffer == [Shard(0), Replicate()]           # tenants on data
    assert sh.token_sketch.fill == [Replicate(), Replicate()]
    tokens = torch.empty((4, 64), device="meta")
    assert S.batch_shardings(cfg, plan, {"tokens": tokens, "labels": tokens}) == {
        "tokens": [Shard(0), Replicate()], "labels": [Shard(0), Replicate()]}
    cache = M.cache_shapes(cfg, 4, 96)
    assert S.cache_shardings(cfg, plan, cache) == {
        "k": [Shard(1), Shard(2)], "v": [Shard(1), Shard(2)]}             # batch, sequence
    # B 1 cannot fill the data axis: the sequence takes both
    cache = M.cache_shapes(cfg, 1, 96)
    assert S.cache_shardings(cfg, plan, cache)["k"] == [Shard(2), Shard(2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_admit_every_family(arch):
    """Every arch's prefill, serve and train steps are built on a mesh plan:
    dense (GQA and MLA), MoE, ssm, hybrid, audio and vlm."""
    cfg = get_arch(arch)
    plan = ShardingPlan(cfg, _Mesh({"data": 1, "model": 1}))
    assert callable(S.make_prefill_step(cfg, plan))
    for make in (S.make_serve_step, S.make_train_step):
        assert callable(make(cfg, plan, device="cpu"))
    assert not hasattr(M, "check_sharded_family") and not hasattr(M, "SHARDED_FAMILIES")


@pytest.mark.parametrize("s,k,e,cap", [(16, 2, 4, 9), (16, 2, 4, 3), (32, 8, 16, 1),
                                       (7, 3, 5, 2), (1, 8, 128, 1)])
def test_dispatch_of_each_half_is_the_whole_batch_rows(s, k, e, cap):
    """The dispatch is per row: each rank of a mesh runs it on its own rows
    (``moe._LocalRows``), and the two halves of a batch give exactly the
    whole batch's slot, token, keep, order and counts, row for row; the
    per-row counts summed over both halves are the batch's."""
    from repro_torch.models import moe
    rng = np.random.default_rng(s * 100 + cap)
    top_e = torch.from_numpy(rng.integers(0, e, (4, s, k)).astype(np.int32))
    whole = moe.dispatch(top_e, cap, e)
    halves = [moe.dispatch(top_e[:2], cap, e), moe.dispatch(top_e[2:], cap, e)]
    for i, name in enumerate(("slot", "token_of", "keep", "order", "counts")):
        assert torch.equal(torch.cat([h[i] for h in halves]), whole[i]), name
    total = moe._LocalRows(torch.empty(0)).total
    assert torch.equal(total(halves[0][4]) + total(halves[1][4]), total(whole[4]))
    assert int(total(whole[4]).sum()) == 4 * s * k


def test_local_rows_of_a_plain_tensor_are_the_tensor():
    """Without a mesh ``moe._LocalRows`` changes nothing, so the single-process
    MoE layer runs its own code."""
    from repro_torch.models import moe
    from repro_torch.models.layers import whole_on
    x = torch.randn((2, 3, 4))
    rows = moe._LocalRows(x)
    assert rows.mesh is None
    assert rows.local(x) is x and rows.lift(x) is x and whole_on(x, 1) is x


def test_placements_refuse_a_mesh_axis_named_twice():
    with pytest.raises(ValueError, match="'model'"):
        placements((None, ("data", "model"), None, "model"), _Mesh({"data": 2, "model": 4}))


@pytest.mark.parametrize("b", [4, 8])
def test_ssm_cache_shardings_under_no_tp_as_jaxs(b):
    """mamba2-130m under ``no_tp`` on a ``(2, 4)`` ``data × model`` mesh
    (JAX's ``NamedSharding`` over an ``AbstractMesh`` of those axes): at B 4
    the batch is on ``data`` and both packages lay the window's channels
    and the state's columns on ``model``; at B 8 the batch takes ``("data",
    "model")`` and the same specs name ``model`` twice, which JAX refuses
    (``DuplicateSpecError``) and so does the port (``ValueError``)."""
    from jax.sharding import AbstractMesh

    from repro.train import steps as JS
    jplan, plan = _plans("mamba2-130m", "dm24", "no_tp")
    jplan.mesh = AbstractMesh((2, 4), ("data", "model"))
    jcfg, cfg = jax_arch("mamba2-130m"), get_arch("mamba2-130m")
    jcache = jax_decode_shapes(jcfg, dataclasses.replace(JSHAPES["decode_32k"],
                                                         global_batch=b))["cache"]
    cache = M.cache_shapes(cfg, b, 32_768)
    if b == 8:
        with pytest.raises(Exception) as refused:
            JS.cache_shardings(jcfg, jplan, jcache)
        assert type(refused.value).__name__ == "DuplicateSpecError"
        with pytest.raises(ValueError, match="'model' twice"):
            S.cache_shardings(cfg, plan, cache)
        return
    want = {n: placements(tuple(s.spec), plan.mesh)
            for n, s in JS.cache_shardings(jcfg, jplan, jcache).items()}
    assert S.cache_shardings(cfg, plan, cache) == want == {
        "ssm_state": [Shard(1), Shard(5)], "conv": [Shard(1), Shard(3)]}
