"""repro_torch's StreamRuntime over torch.distributed (gloo, CPU) at p > 1.

The DESIGN §8.2 invariant across processes: a sharded runtime's snapshot,
on every rank, is bitwise the single-process engine's over the same
shards × lanes block decomposition, for every reduction strategy ×
{torch, sorted}, with ``hierarchical`` on a ("pod", "data") mesh of 2 pods
at p 4. That single-process snapshot is held against the JAX package's
``SketchEngine`` (sorted) in this process. The ranks run in a subprocess
(``torch.multiprocessing.spawn``, one per world size p ∈ {2, 3, 4}),
rendezvousing through a ``file://`` under ``tmp_path`` so parallel test
workers never collide; they write their results as ``.npz`` files.

The chunk-boundary case is ``tests/test_sharding_dist.py``'s: off-chunk
blocks are rejected, and chunk-padded ones cross a flush boundary with
EMPTY-padded partial chunks, fill cursor included.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro_torch.core.parallel import block_decompose
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.runtime import host_blocks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
K, LANES, CHUNK, DEPTH = 64, 2, 64, 4
IMPLS = ("torch", "sorted")
STRATEGIES = ("butterfly", "allgather", "hierarchical")
ODD = 100                      # an off-chunk block width; padded to 2 chunks

# Each rank: every strategy × impl, a feed, the chunk-boundary case, and
# the error paths; results land in <root>/<case>_r<rank>.npz.
WORKER = r'''
import json, sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

K, LANES, CHUNK, DEPTH, ODD = {K}, {LANES}, {CHUNK}, {DEPTH}, {ODD}
IMPLS, STRATEGIES = {IMPLS!r}, {STRATEGIES!r}


def save(root, name, rank, snap=None, **extra):
    arrays = dict(extra)
    if snap is not None:
        arrays.update(items=snap.summary.items.numpy(), counts=snap.summary.counts.numpy(),
                      errors=snap.summary.errors.numpy(), n=snap.n.numpy(),
                      shard_n=snap.shard_n.numpy())
    np.savez(root / f"{{name}}_r{{rank}}.npz", **arrays)


def worker(rank, world, root):
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{{root}}/rendezvous",
                            rank=rank, world_size=world)
    from repro_torch.core.parallel import axis_groups, hierarchical_combine
    from repro_torch.core.spacesaving import init_summary
    from repro_torch.engine import EngineConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import RuntimeConfig, StreamRuntime

    def runtime(kernel, reduction, pods=1):
        return StreamRuntime(RuntimeConfig(
            engine=EngineConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH,
                                kernel=kernel, device="cpu"),
            shards=world, pods=pods, reduction=reduction))

    stream = np.load(root / "stream.npy")
    for impl in IMPLS:
        for strategy in STRATEGIES:
            pods = 2 if (strategy == "hierarchical" and world == 4) else 1
            rt = runtime(impl, strategy, pods)
            st = rt.ingest(rt.init(), stream)
            save(root, f"{{impl}}_{{strategy}}", rank, rt.snapshot(st), fill=st.fill)

    # feed == the engine over the same host blocks, through flushes
    rt = runtime("sorted", "butterfly")
    blocks = [np.load(root / f"block{{i}}.npy") for i in range(3)]
    save(root, "feed", rank, rt.snapshot(rt.feed(rt.init(), iter(blocks))))

    # off-chunk blocks are refused; chunk-padded ones cross a flush boundary
    odd = np.load(root / "odd.npy")
    try:
        rt.ingest(rt.init(), odd)
        refused = ""
    except ValueError as e:
        refused = str(e)
    padded = np.concatenate([odd, np.full((odd.shape[0], 2 * CHUNK - ODD), -1, odd.dtype)], 1)
    st = rt.init()
    for _ in range(3):
        st = rt.ingest(st, padded)
    save(root, "boundary", rank, rt.snapshot(st), fill=st.fill)

    # the error paths name what is missing
    errors = {{"refused": refused}}
    mesh = make_host_mesh(n_data=world, device_type="cpu")
    s = init_summary(K, device="cpu")
    for name, call in (
            ("axis", lambda: axis_groups(mesh, ("data", "pod"))),
            ("cross_pod", lambda: hierarchical_combine(s, mesh.get_group("data"), "pod")),
            ("mesh_size", lambda: make_host_mesh(n_data=world + 1, device_type="cpu")),
            ("shards", lambda: StreamRuntime(RuntimeConfig(
                engine=EngineConfig(k=K, tenants=LANES, device="cpu"), shards=world + 1)))):
        try:
            call()
            errors[name] = ""
        except ValueError as e:
            errors[name] = str(e)
    (root / f"errors_r{{rank}}.json").write_text(json.dumps(errors))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    world = int(sys.argv[1])
    mp.spawn(worker, args=(world, sys.argv[2]), nprocs=world, join=True)
'''.format(K=K, LANES=LANES, CHUNK=CHUNK, DEPTH=DEPTH, ODD=ODD, IMPLS=IMPLS,
           STRATEGIES=STRATEGIES)


def _stream():
    return zipf_stream(6_000, 1.2, seed=0, max_id=10**4)


def _blocks(p):
    w = p * LANES
    sizes = (2 * w * CHUNK, 2 * w * CHUNK, w * CHUNK + 37)
    return [zipf_stream(n, 1.1, seed=10 + i, max_id=10**4) for i, n in enumerate(sizes)]


def _odd(p):
    return zipf_stream(p * LANES * ODD, 1.2, seed=5, max_id=10**4).reshape(p * LANES, ODD)


@pytest.fixture(scope="module", params=[2, 3, 4])
def ranks(request, tmp_path_factory):
    """(p, root): p ranks ran the worker once; their results are under root."""
    p = request.param
    root = tmp_path_factory.mktemp(f"dist{p}")
    np.save(root / "stream.npy", _stream())
    np.save(root / "odd.npy", _odd(p))
    for i, b in enumerate(_blocks(p)):
        np.save(root / f"block{i}.npy", b)
    script = root / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, str(script), str(p), str(root)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return p, root


def _engine(p, kernel="sorted"):
    return SketchEngine(EngineConfig(k=K, tenants=p * LANES, chunk=CHUNK,
                                     buffer_depth=DEPTH, kernel=kernel, device="cpu"))


def _assert_ranks_equal(p, root, name, snap, fill=None):
    for rank in range(p):
        got = np.load(root / f"{name}_r{rank}.npz")
        for leaf, want in zip(("items", "counts", "errors"), snap.summary):
            np.testing.assert_array_equal(got[leaf], want.numpy(),
                                          err_msg=f"{name} rank {rank} {leaf}")
        assert int(got["n"]) == int(snap.n)
        np.testing.assert_array_equal(got["shard_n"], snap.shard_n.numpy())
        if fill is not None:
            assert int(got["fill"]) == fill


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_runtime_matches_single_process_engine(ranks, impl, strategy):
    p, root = ranks
    eng = _engine(p, impl)
    st = eng.ingest(eng.init(), block_decompose(_stream(), p * LANES, CHUNK))
    _assert_ranks_equal(p, root, f"{impl}_{strategy}", eng.snapshot(st), st.fill)


def test_single_process_engine_matches_repro(ranks):
    """The reference of the sharded runs, held against the JAX engine."""
    p, _ = ranks
    eng = _engine(p)
    blocks = block_decompose(_stream(), p * LANES, CHUNK)
    snap = eng.snapshot(eng.ingest(eng.init(), blocks))
    je = JEngine(JConfig(k=K, tenants=p * LANES, chunk=CHUNK, buffer_depth=DEPTH,
                         kernel="sorted"))
    jsnap = je.snapshot(je.ingest(je.init(), blocks.numpy()))
    for a, b in zip(jsnap.summary, snap.summary):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jsnap.n) == int(snap.n)
    np.testing.assert_array_equal(np.asarray(jsnap.shard_n), snap.shard_n.numpy())
    assert jax.devices()[0].platform == "cpu"


def test_sharded_feed_matches_engine(ranks):
    p, root = ranks
    eng = _engine(p)
    st = eng.init()
    for b in _blocks(p):
        st = eng.ingest(st, host_blocks(b, p * LANES, CHUNK))
    _assert_ranks_equal(p, root, "feed", eng.snapshot(st))


def test_sharded_chunk_boundary_matches_engine(ranks):
    p, root = ranks
    eng = _engine(p)
    odd = _odd(p)
    padded = np.concatenate([odd, np.full((p * LANES, 2 * CHUNK - ODD), -1, odd.dtype)], 1)
    st = eng.init()
    for _ in range(3):                       # 6 chunks: a flush, then fill 2
        st = eng.ingest(st, padded)
    assert st.fill == 2
    _assert_ranks_equal(p, root, "boundary", eng.snapshot(st), st.fill)


def test_sharded_errors_name_what_is_missing(ranks):
    p, root = ranks
    for rank in range(p):
        errors = json.loads((root / f"errors_r{rank}.json").read_text())
        assert "multiple of the engine chunk" in errors["refused"]
        assert "mesh dimension 'pod' does not exist" in errors["axis"]
        assert "cross-pod group" in errors["cross_pod"]
        assert "does not exist" in errors["cross_pod"]
        assert f"requested {p + 1} ranks but only {p} rank(s)" in errors["mesh_size"]
        assert f"requested {p + 1} shards but only {p} rank(s)" in errors["shards"]
