"""repro_torch.launch.inputs against repro.launch.inputs.

For every arch × every shape cell, the ``meta`` stand-ins of the train,
prefill and decode inputs have JAX's names, shapes and dtypes (the decode
cache for the dense, MLA and MoE families, the ones the port's model runs;
every other family raises NotImplementedError there). ``materialize`` gives real
tensors of those shapes and dtypes, int32 leaves inside the vocab, from a
seeded generator (the same bits twice).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_arch
from repro.launch import inputs as JI
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, get_arch, get_smoke_arch
from repro_torch.launch import inputs as I


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), jnp.dtype(v.dtype).name)
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_decode_shapes_equal_jax(arch, shape):
    cfg, jcfg, sh = get_arch(arch), jax_arch(arch), SHAPES[shape]
    for ours, theirs in ((I.train_batch_shapes, JI.train_batch_shapes),
                         (I.prefill_batch_shapes, JI.prefill_batch_shapes)):
        got = ours(cfg, sh)
        assert all(t.device.type == "meta" for t in got.values())
        assert _flat(got) == _jflat(theirs(jcfg, sh))
    if cfg.family in ("dense", "moe"):
        assert _flat(I.decode_input_shapes(cfg, sh)) == _jflat(JI.decode_input_shapes(jcfg, sh))
    else:
        with pytest.raises(NotImplementedError):
            I.decode_input_shapes(cfg, sh)


def test_materialize_fills_every_leaf():
    cfg = get_smoke_arch("qwen2.5-14b")
    sh = SHAPES["decode_32k"]
    small = type(sh)(sh.name, 16, 2, sh.kind)
    shapes = {**I.train_batch_shapes(cfg, small), "decode": I.decode_input_shapes(cfg, small)}
    a = I.materialize(shapes, torch.Generator().manual_seed(0), vocab=cfg.vocab)
    b = I.materialize(shapes, torch.Generator().manual_seed(0), vocab=cfg.vocab)
    assert _flat(a) == _flat(shapes)
    for (name, x), y in zip(_flat_tensors(a), (t for _, t in _flat_tensors(b))):
        assert x.device.type == "cpu" and torch.equal(x, y), name
        if x.dtype == torch.int32:
            assert 0 <= int(x.min()) and int(x.max()) < cfg.vocab
        else:
            assert 0 < float(x.abs().max()) < 0.2
    jshapes = JI.train_batch_shapes(jax_arch("qwen2.5-14b"), small)
    jreal = JI.materialize(jshapes, jax.random.PRNGKey(0), vocab=cfg.vocab)
    assert {k: (v.shape, v.dtype) for k, v in jreal.items()} == \
        {k: (tuple(v.shape), np.int32) for k, v in a.items() if k in jshapes}


def _flat_tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tensors(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v
