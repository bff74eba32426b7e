"""repro_torch.data.synthetic's TokenStream against repro.data.synthetic.

Both are numpy, so every batch is compared bit for bit (tolerance 0): the
tokens, labels and the whisper / qwen2-vl extras over a grid of (seed,
step), an exact resume from a DataState, and labels that are the tokens
shifted by one. The JAX package's module imports no JAX.
"""
import numpy as np
import pytest

from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.data.synthetic import DataState as JDataState
from repro.data.synthetic import TokenStream as JTokenStream
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.data.synthetic import DataState, TokenStream

GRID = [(seed, step) for seed in (0, 1234, 2**31 - 1) for step in (0, 1, 7, 1000)]


@pytest.mark.parametrize("seed,step", GRID)
def test_token_batches_equal_jax(seed, step):
    ours = TokenStream(152064, 4, 64, state=DataState(seed, step))
    theirs = JTokenStream(152064, 4, 64, state=JDataState(seed, step))
    for _ in range(2):
        a, b = ours.next(), theirs.next()
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype == np.int32
            np.testing.assert_array_equal(a[name], b[name])
        assert ours.state.to_dict() == theirs.state.to_dict()


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b", "qwen2.5-14b"])
@pytest.mark.parametrize("seed,step", [(0, 0), (1234, 5)])
def test_extras_equal_jax(arch, seed, step):
    ours = TokenStream(512, 2, 16, state=DataState(seed, step))
    theirs = JTokenStream(512, 2, 16, state=JDataState(seed, step))
    a, b = ours.extras(get_smoke_arch(arch)), theirs.extras(jax_smoke_arch(arch))
    assert a.keys() == b.keys()
    assert bool(a) == (arch != "qwen2.5-14b")
    for name in a:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])


def test_resume_is_exact():
    a = TokenStream(1000, 4, 16)
    batches = [a.next() for _ in range(5)]
    saved = DataState.from_dict(DataState(seed=1234, step=3).to_dict())
    b = TokenStream(1000, 4, 16, state=saved)
    for want in batches[3:]:
        got = b.next()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    assert b.state == a.state == DataState(1234, 5)


def test_labels_are_shifted_tokens():
    s = TokenStream(1000, 2, 8)
    b = s.next()
    assert b["tokens"].shape == b["labels"].shape == (2, 8)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].min() >= 1 and b["tokens"].max() <= 999    # mod-folded ids
