"""repro_torch.kernels against repro.kernels, and the kernels' guard rails.

The plain versions (dense and sorted) are held bit for bit against the JAX
references on the same numpy inputs; the kernel wrappers, on a CPU tensor,
compute the plain version, and on one small shape (k = 64, c = 128) they
are held against the Pallas kernels run in interpret mode. The CUDA
kernels themselves run only on a card (``tests/test_torch_gpu.py``). The
last tests check that the port imports neither JAX nor the JAX package,
and imports without ``nvcc``.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref, ss_combine, ss_query
from repro_torch.plan import PLAN_OPS, static_impl
from repro_torch.plan import service as plan_service

# one intra-op thread per test process: the suite runs in parallel
# workers, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(8, 16), (100, 57), (64, 2048), (2048, 64)]


def summary_ids(rng, k, id_range, distinct):
    if distinct:
        ids = np.full(k, -1, np.int32)
        n = min(k, id_range) * 3 // 4
        ids[rng.permutation(k)[:n]] = rng.choice(id_range, n, replace=False)
        return ids
    return rng.integers(-1, id_range, k).astype(np.int32)


def candidates(rng, c, id_range):
    """Candidate ids with duplicates and EMPTY, counts and errors."""
    ids = rng.integers(-1, id_range, c).astype(np.int32)
    return ids, rng.integers(0, 1000, c).astype(np.int32), \
        rng.integers(0, 50, c).astype(np.int32)


def t(*arrays):
    return tuple(None if a is None else torch.from_numpy(np.array(a)) for a in arrays)


def j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def assert_outputs(jout, tout):
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert (a is None) == (b is None)
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.numpy().dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("with_errors", [False, True])
@pytest.mark.parametrize("k,c", SHAPES)
def test_combine_match_ref_bitwise_with_duplicates(rng, k, c, with_errors):
    """Dense plain version vs the JAX dense reference; batched over 3 rows."""
    rows = [(summary_ids(rng, k, 60, distinct=False), *candidates(rng, c, 60))
            for _ in range(3)]
    s, ci, cc, ce = (np.stack(a) for a in zip(*rows))
    ce = ce if with_errors else None
    out = ref.combine_match_ref(*t(s, ci, cc, ce))
    for b in range(3):
        jout = jref.combine_match_ref(*j(s[b], ci[b], cc[b],
                                         None if ce is None else ce[b]))
        assert_outputs(jout, tuple(None if o is None else o[b] for o in out))
        # the wrapper on a CPU tensor is the plain version
    before = ss_combine.LAUNCHES
    for a, b in zip(out, ss_combine.combine_match(*t(s, ci, cc, ce))):
        assert (a is None and b is None) or torch.equal(a, b)
    assert ss_combine.LAUNCHES == before


@pytest.mark.parametrize("k,c", SHAPES)
def test_combine_match_sorted_bitwise(rng, k, c):
    """Sorted merge-join: distinct valid ids on both sides, as in every summary."""
    s = np.stack([summary_ids(rng, k, 4 * k, distinct=True) for _ in range(2)])
    ci = np.stack([summary_ids(rng, c, 4 * k, distinct=True) for _ in range(2)])
    cc = rng.integers(0, 1000, (2, c)).astype(np.int32)
    ce = rng.integers(0, 50, (2, c)).astype(np.int32)
    out = ref.combine_match_sorted(*t(s, ci, cc, ce))
    dense = ref.combine_match_ref(*t(s, ci, cc, ce))
    for a, b in zip(out, dense):
        assert torch.equal(a, b)
    for b in range(2):
        assert_outputs(jref.combine_match_sorted(*j(s[b], ci[b], cc[b], ce[b])),
                       tuple(o[b] for o in out))
    assert ref.combine_match_sorted(*t(s, ci, cc, None))[1] is None


@pytest.mark.parametrize("k,q", [(16, 8), (100, 33), (2048, 300)])
def test_query_ref_and_sorted_bitwise(rng, k, q):
    si = summary_ids(rng, k, 4 * k, distinct=True)
    sc = (rng.integers(1, 1000, k) * (si != -1)).astype(np.int32)
    se = (rng.integers(0, 50, k) * (si != -1)).astype(np.int32)
    qs = np.concatenate([si[:q // 2], rng.integers(-1, 4 * k, q - q // 2)]).astype(np.int32)
    assert_outputs(jref.query_ref(*j(si, sc, se, qs)), ref.query_ref(*t(si, sc, se, qs)))
    assert_outputs(jref.query_sorted(*j(si, sc, se, qs)),
                   ref.query_sorted(*t(si, sc, se, qs)))
    before = ss_query.LAUNCHES
    for a, b in zip(ref.query_ref(*t(si, sc, se, qs)), ss_query.query(*t(si, sc, se, qs))):
        assert torch.equal(a, b)
    assert ss_query.LAUNCHES == before


def test_small_shape_against_pallas_interpret(rng):
    """k = 64, c = 128: the Pallas kernels (interpret mode) vs the port."""
    s = summary_ids(rng, 64, 100, distinct=False)
    ci, cc, ce = candidates(rng, 128, 100)
    pallas = jops.combine_match(*j(s, ci, cc, ce), impl="pallas")
    for impl in ("auto", "torch"):
        assert_outputs(pallas, ops.combine_match(*t(s, ci, cc, ce), impl=impl))
    assert_outputs(pallas, ss_combine.combine_match(*t(s, ci, cc, ce)))
    sc = (rng.integers(1, 1000, 64) * (s != -1)).astype(np.int32)
    se = (rng.integers(0, 50, 64) * (s != -1)).astype(np.int32)
    qs = rng.integers(-1, 120, 128).astype(np.int32)
    pallas_q = jops.query(*j(s, sc, se, qs), impl="pallas")
    assert_outputs(pallas_q, ops.query(*t(s, sc, se, qs), impl="torch"))
    assert_outputs(pallas_q, ss_query.query(*t(s, sc, se, qs)))


def test_window_ops_match_jax(rng):
    k, w = 64, 256
    s = np.stack([summary_ids(rng, k, 300, distinct=True) for _ in range(2)])
    cnt = (rng.integers(1, 9, (2, k)) * (s != -1)).astype(np.int32)
    err = np.zeros_like(cnt)
    win = rng.integers(-1, 300, (2, w)).astype(np.int32)
    jout = jops.ingest_window(*j(s, cnt, err, win), impl="jnp")
    for impl in ("torch", "sorted", "auto"):
        assert_outputs(jout, ops.ingest_window(*t(s, cnt, err, win), impl=impl))
    jc = jops.combine_summaries(*j(s[0], cnt[0], err[0], s[1], cnt[1], err[1]), impl="jnp")
    assert_outputs(jc, ops.combine_summaries(*t(s[0], cnt[0], err[0], s[1], cnt[1],
                                                err[1]), impl="sorted"))


def test_impl_resolution_and_refusals(rng, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))   # no plan: static rule
    plan_service.clear()
    assert ops.resolve_impl("combine", 64, "cpu") == "torch"
    assert ops.resolve_impl("combine", 256, "cpu") == "sorted"
    assert static_impl("combine", 64, on_cuda=True) == "cuda"
    assert ops._impl("sorted", "combine", 64, "cuda") == "sorted"
    args = t(summary_ids(rng, 8, 20, False), *candidates(rng, 16, 20))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.combine_match(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.query(args[0], args[2][:8], args[3][:8], args[1], impl="cuda")
    # 'fused' is the window-level kernels; at the sub-op surfaces it is their
    # matcher, 'sorted', and 'auto' never picks it
    assert ops._impl("fused", "combine", 64, "cpu") == "fused"
    assert "fused" not in {static_impl(op, k, on_cuda=c) for op in PLAN_OPS
                           for k in (64, 4096) for c in (False, True)}
    for a, b in zip(ops.combine_match(*args, impl="fused"),
                    ops.combine_match(*args, impl="sorted")):
        assert torch.equal(a, b)
    q = (args[0], args[2][:8], args[3][:8], args[1])
    for a, b in zip(ops.query(*q, impl="fused"), ops.query(*q, impl="sorted")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ops.query(args[0], args[2][:8], args[3][:8], args[1], impl="pallas")


def test_wrappers_check_their_inputs(rng):
    s, ci, cc, ce = t(summary_ids(rng, 8, 20, False), *candidates(rng, 16, 20))
    with pytest.raises(TypeError):
        ss_combine.combine_match(s.long(), ci, cc, ce)
    with pytest.raises(TypeError):
        ss_combine.combine_match(s, ci, cc.float(), None)
    with pytest.raises(TypeError):
        ss_combine.combine_match(s, ci, cc, ce.long())
    with pytest.raises(ValueError, match="contiguous"):
        ss_combine.combine_match(s, ci[::2], cc[::2], None)
    with pytest.raises(ValueError, match="batch"):
        ss_combine.combine_match(s[None].expand(2, -1).contiguous(), ci, cc, None)
    with pytest.raises(ValueError):
        ss_combine.combine_match(s, ci, cc[:4], None)
    with pytest.raises(TypeError):
        ss_query.query(s, cc[:8].long(), ce[:8], ci)
    with pytest.raises(ValueError):
        ss_query.query(s, cc[:4], ce[:4], ci)
    with pytest.raises(ValueError, match="contiguous"):
        ss_query.query(s, cc[:8], ce[:8], ci[::2])


# (k, count dtype, errors channel) -> (table slots, table bytes, fits in 227 KB)
HASH_TABLES = [
    ((0, torch.int32, False), (64, 576, True)),
    ((32, torch.int32, False), (64, 576, True)),
    ((33, torch.int32, False), (128, 1152, True)),
    ((2048, torch.int32, False), (4096, 36864, True)),     # the flush shape
    ((2048, torch.int32, True), (4096, 53248, True)),      # a COMBINE round
    ((2049, torch.int32, False), (8192, 73728, True)),
    ((8192, torch.int32, False), (16384, 147456, True)),
    ((8192, torch.int32, True), (16384, 212992, True)),
    ((8192, torch.int64, False), (16384, 212992, True)),
    ((8193, torch.int32, False), (32768, 294912, False)),
    ((4096, torch.int64, True), (8192, 172032, True)),
    ((4097, torch.int64, True), (16384, 344064, False)),
    ((8192, torch.int64, True), (16384, 344064, False)),
]


@pytest.mark.parametrize("shape,want", HASH_TABLES)
def test_hash_table_size_and_fit(shape, want):
    """Slots are the least power of two >= 2k (at least 64); a slot takes an
    int32 id, a one-byte flag and one accumulator of the count type per
    channel; the table fits where it takes at most 227 KB of shared memory."""
    k, dtype, errors = shape
    assert ss_combine.SMEM_BYTES == 227 * 1024
    assert (ss_combine.table_slots(k), ss_combine.table_bytes(k, dtype, errors),
            ss_combine.hash_fits(k, dtype, errors)) == want
    assert ss_combine.kernel_for(1, k, 8, dtype, errors) == ("hash" if want[2] else "dense")


@pytest.mark.parametrize("b", [65535, 65536, 65537, 2**20])
def test_wrappers_take_batches_above_65535(b):
    """The kernels take the batch on grid.x: no wrapper refuses a batch above
    grid.y's 65 535 before the launch, only one that needs more than
    2^31 - 1 blocks."""
    assert ss_combine.kernel_for(b, 16, 16, torch.int32, True) == "hash"
    assert ss_combine.kernel_for(b, 8193, 16, torch.int32, False) == "dense"
    assert ss_combine.kernel_for(b, 2048, 16, torch.int64, False) == "hash"  # ss_match
    ss_query.check_launch(b, 16, 16)
    ss_query.check_launch(b, 2048, 4096)


def test_wrappers_refuse_grids_above_2_31_blocks():
    with pytest.raises(ValueError, match="blocks"):
        ss_combine.kernel_for(2**31, 16, 16, torch.int32, False)
    with pytest.raises(ValueError, match="blocks"):          # 33 blocks an entry
        ss_combine.kernel_for(2**26, 8193, 16, torch.int32, False)
    ss_combine.kernel_for(2**26, 16, 16, torch.int32, False)
    with pytest.raises(ValueError, match="blocks"):          # 128 blocks an entry
        ss_query.check_launch(2**24, 16, 2**17)
    ss_query.check_launch(2**24, 16, 2**16)


def test_combine_wrapper_takes_a_kernel_name_and_checks_it(rng):
    """The private entry names the kernel (the public wrapper takes the shape
    rule only); on the CPU the plain version answers for either name."""
    args = t(summary_ids(rng, 8, 20, False), *candidates(rng, 16, 20))
    want = ref.combine_match_ref(*args)
    for kernel in (None, "hash", "dense"):
        for a, b in zip(ss_combine._combine_match(*args, kernel), want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="kernel"):
        ss_combine._combine_match(*args, "sorted")


def test_build_is_lazy_and_hash_named():
    assert build.sources() == ["ss_combine", "ss_ingest", "ss_query"]
    for name in build.sources():
        lib = build.library_path(name)
        assert lib.parent == ROOT / "build" / "kernels"
        assert lib == build.library_path(name) and lib.suffix == ".so"


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_library_path_hashes_the_headers_too(tmp_path, monkeypatch, edit):
    """Each library's name hashes its source and every ``csrc/*.cuh``: in a
    copy of ``csrc/``, editing the shared hash-table header (or adding a
    header) renames all three libraries, so each is rebuilt; editing one
    source renames only its own. A header is no library of its own."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert (csrc / "ss_hash.cuh").exists() and build.sources() == [
        "ss_combine", "ss_ingest", "ss_query"]
    before = {n: build.library_path(n) for n in build.sources()}
    if edit == "header":
        (csrc / "ss_hash.cuh").write_text((csrc / "ss_hash.cuh").read_text() + "// edit\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        (csrc / "ss_query.cu").write_text((csrc / "ss_query.cu").read_text() + "// edit\n")
    after = {n: build.library_path(n) for n in build.sources()}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == ({"ss_query"} if edit == "source" else set(before))
    assert build.sources() == ["ss_combine", "ss_ingest", "ss_query"]


def test_import_and_cpu_use_need_no_nvcc(tmp_path):
    """Importing every module, and using it on the CPU, needs no nvcc."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import build, ops\n"
        "s = torch.tensor([3, -1, 5], dtype=torch.int32)\n"
        "ops.combine_match(s, s, s)\n"
        "try:\n    build.nvcc()\nexcept RuntimeError:\n    print('no-nvcc')\n"
        "import sys; assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": str(tmp_path),
           "CUDA_HOME": str(tmp_path / "no-cuda"), "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["no-nvcc", "ok"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
