"""repro_torch.configs against repro.configs: copies, field for field.

Every arch and its smoke variant is ``dataclasses.asdict``-equal to the
JAX package's, as are ``SHAPES``, ``PAPER_STREAM_CONFIGS`` and each arch's
``shape_cells``. ``param_count`` (total, ``active_only``, with the
embeddings) equals JAX's for the dense, MLA, MoE, audio and vlm archs at
full and smoke size (whisper-tiny's and qwen2-vl-72b's full sizes also
against the values JAX's ``param_count`` gives): the port counts ``numel`` of a model built on the ``meta``
device, so nothing is allocated, and scales the expert stacks by top_k/E
for ``active_only``. Integers: tolerance 0.
"""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro.models import model as JM
from repro_torch.configs import registry as reg
from repro_torch.models import model as M

DENSE = ["qwen2.5-14b", "yi-34b", "qwen1.5-110b",
         "minicpm3-4b", "qwen3-moe-30b-a3b", "mixtral-8x7b", "whisper-tiny", "qwen2-vl-72b"]
# JAX's param_count at full size: (without, with) the embeddings
FULL_COUNTS = {"whisper-tiny": (16_561_152, 56_393_472),
               "qwen2-vl-72b": (70_214_787_072, 72_706_203_648)}


def test_registry_names_equal():
    assert list(reg.ARCHS) == list(jreg.ARCHS)


@pytest.mark.parametrize("name", sorted(jreg.ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_arch_equal_jax(name, smoke):
    get, jget = ((reg.get_smoke_arch, jreg.get_smoke_arch) if smoke
                 else (reg.get_arch, jreg.get_arch))
    ours, theirs = get(name), jget(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.hd, ours.n_q_heads, ours.attention_free, ours.subquadratic) == \
        (theirs.hd, theirs.n_q_heads, theirs.attention_free, theirs.subquadratic)
    cells = [(dataclasses.asdict(s), why) for s, why in reg.shape_cells(ours)]
    jcells = [(dataclasses.asdict(s), why) for s, why in jreg.shape_cells(theirs)]
    assert cells == jcells


def test_shapes_and_paper_configs_equal_jax():
    assert {n: dataclasses.asdict(s) for n, s in reg.SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in jreg.SHAPES.items()}
    assert reg.PAPER_STREAM_CONFIGS == jreg.PAPER_STREAM_CONFIGS


def test_overrides_equal_jax():
    kw = dict(swa_window=8, q_head_pad=1, n_layers=3)
    assert dataclasses.asdict(reg.get_smoke_arch("qwen2.5-14b", **kw)) == \
        dataclasses.asdict(jreg.get_smoke_arch("qwen2.5-14b", **kw))
    with pytest.raises(KeyError):
        reg.get_arch("gpt-5")


@pytest.mark.parametrize("name", DENSE)
def test_param_count_equals_jax_at_full_size(name):
    cfg, jcfg = reg.get_arch(name), jreg.get_arch(name)
    for kw in ({}, {"active_only": True}, {"include_embed": True}):
        assert M.param_count(cfg, **kw) == JM.param_count(jcfg, **kw), kw
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    if name in FULL_COUNTS:
        assert (M.param_count(cfg), M.param_count(cfg, include_embed=True)) == \
            FULL_COUNTS[name]


@pytest.mark.parametrize("name", DENSE)
def test_param_count_equals_jax_at_smoke_size(name):
    for kw in ({}, {"q_head_pad": 1}, {"tie_embeddings": True}):
        cfg, jcfg = reg.get_smoke_arch(name, **kw), jreg.get_smoke_arch(name, **kw)
        for count in ({"include_embed": True}, {"active_only": True}):
            assert M.param_count(cfg, **count) == JM.param_count(jcfg, **count), (kw, count)
