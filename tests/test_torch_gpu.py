"""The port's CUDA kernels and main path on a card (``gpu`` marker).

Each test skips itself where ``torch.cuda.is_available()`` is false, so on
a CPU-only machine every test here is skipped. The file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -q

Integer sums make every comparison exact (no tolerance): kernel vs plain
version, and impl="cuda" vs impl="sorted" through the engine.
"""
import numpy as np
import pytest
import torch

from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.eval.accuracy import check_record, run_cell
from repro_torch.kernels import build, ops, ref, ss_combine, ss_query

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def ids(rng, shape, id_range, device):
    return torch.from_numpy(rng.integers(-1, id_range, shape).astype(np.int32)).to(device)


def test_build_all_compiles_every_source(cuda):
    libs = build.build_all()
    assert sorted(libs) == build.sources()
    assert all(p.exists() for p in libs.values())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("with_errors", [False, True])
@pytest.mark.parametrize("k,c", [(1, 1), (700, 5000), (2048, 2049)])
def test_combine_kernel_equals_plain(cuda, rng, dtype, with_errors, k, c):
    """Duplicates and EMPTY on both sides, ragged shapes, 3 batch rows."""
    s, ci = ids(rng, (3, k), 300, cuda), ids(rng, (3, c), 300, cuda)
    cc = torch.randint(0, 1 << 20, (3, c), device=cuda).to(dtype)
    ce = torch.randint(0, 1 << 10, (3, c), device=cuda).to(dtype)
    if dtype == torch.int64:
        cc += 1 << 33
    ce = ce if with_errors else None
    before = ss_combine.LAUNCHES
    got = ss_combine.combine_match(s, ci, cc, ce)
    torch.cuda.synchronize()
    assert ss_combine.LAUNCHES == before + 1
    for a, b in zip(got, ref.combine_match_ref(s, ci, cc, ce)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("q", [1, 16, 4096])
def test_query_kernel_equals_plain(cuda, rng, q):
    s = ids(rng, (2048,), 9000, cuda)
    sc = torch.randint(1, 1 << 20, (2048,), dtype=torch.int32, device=cuda)
    se = torch.randint(0, 1 << 10, (2048,), dtype=torch.int32, device=cuda)
    qs = ids(rng, (q,), 9000, cuda)
    before = ss_query.LAUNCHES
    got = ss_query.query(s, sc, se, qs)
    torch.cuda.synchronize()
    assert ss_query.LAUNCHES == before + 1
    for a, b in zip(got, ref.query_ref(s, sc, se, qs)):
        assert torch.equal(a, b)


def test_wrappers_refuse_mixed_devices(cuda, rng):
    s, ci = ids(rng, (64,), 50, cuda), ids(rng, (128,), 50, cuda)
    with pytest.raises(ValueError):
        ss_combine.combine_match(s, ci.cpu(), ci.cpu(), None)
    with pytest.raises(ValueError):
        ss_query.query(s, s, s, ci.cpu())
    assert ops.resolve_impl("auto", 64, cuda) == "cuda"


def test_engine_cuda_equals_sorted_on_card(cuda, rng):
    stream = torch.from_numpy(np.minimum(rng.zipf(1.2, (8, 5000)), 10**5)
                              .astype(np.int32))
    out = {}
    for impl in ("cuda", "sorted"):
        e = SketchEngine(EngineConfig(k=256, tenants=8, chunk=512, buffer_depth=4,
                                      kernel=impl))
        st = e.ingest(e.init(), stream)
        out[impl] = (e.snapshot(st), e.estimate(st, stream[0, :100]))
    (sc, ec), (ss, es) = out["cuda"], out["sorted"]
    for a, b in zip(sc.summary, ss.summary):
        assert torch.equal(a, b)
    for a, b in zip(ec, es):
        assert torch.equal(a, b)


def test_main_path_cell_on_card(cuda):
    cells = []
    for impl in ("cuda", "sorted"):
        cell, snap = run_cell(n=200_000, skew=1.1, k=256, impl=impl, tenants=8,
                              buffer_depth=8, chunk=2048, device="cuda")
        cells.append((cell, snap))
    for a, b in zip(cells[0][1].summary, cells[1][1].summary):
        assert torch.equal(a, b)
    assert check_record({"cells": [c for c, _ in cells]}) == []
