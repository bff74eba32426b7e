"""The port's CUDA kernels and main path on a card (``gpu`` marker).

Each test skips itself where ``torch.cuda.is_available()`` is false, so on
a CPU-only machine every test here is skipped. The file imports neither
JAX nor the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -q

Integer sums make every comparison exact (no tolerance): kernel vs plain
version, and impl="cuda" and impl="fused" vs impl="sorted" through the
engine. The tune CLI runs once at a small grid with ``--check``, its plan
cache under a temporary directory; every test resolves ``'auto'`` against
an empty plan cache of its own. The serving and reduction probes, the
scaling sweep at p = 1 and the obs gates (all but the overhead ratio, a
timing) run at small sizes.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.eval.accuracy import check_record, run_cell
from repro_torch.kernels import build, ops, ref, ss_combine, ss_ingest, ss_match, ss_query
from repro_torch.plan import ExecutionPlan, active_plan, clear, use_plan

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


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


def combine_case(rng, b, k, c, dtype, with_errors, device, *, id_range=300,
                 count_lo=0, count_hi=1 << 20):
    """Ids with duplicates and EMPTY on both sides, counts in [count_lo, count_hi)."""
    s, ci = ids(rng, (b, k), id_range, device), ids(rng, (b, c), id_range, device)
    cc = torch.from_numpy(rng.integers(count_lo, count_hi, (b, c))).to(device=device,
                                                                       dtype=dtype)
    ce = torch.from_numpy(rng.integers(count_lo, count_hi, (b, c))).to(device=device,
                                                                       dtype=dtype)
    return s, ci, cc, ce if with_errors else None


def assert_combine_equals_plain(args, kernel=None):
    before = (ss_combine.LAUNCHES, ss_combine.DENSE_LAUNCHES)
    got = ss_combine._combine_match(*args, kernel)
    torch.cuda.synchronize()
    dtype, errors = args[2].dtype, args[3] is not None
    ran = kernel or ss_combine.kernel_for(args[0].shape[0], args[0].shape[-1],
                                          args[1].shape[-1], dtype, errors)
    if args[0].numel():
        assert (ss_combine.LAUNCHES, ss_combine.DENSE_LAUNCHES) == \
            (before[0] + 1, before[1] + (ran == "dense"))
    for a, b in zip(got, ref.combine_match_ref(*args), strict=True):
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))


@pytest.mark.parametrize("kernel", ["hash", "dense"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("with_errors", [False, True])
@pytest.mark.parametrize("case", ["all_empty_rows", "c0", "ragged", "zero_counts",
                                  "wrap", "distinct"])
def test_combine_kernels_on_edge_cases(cuda, rng, kernel, dtype, with_errors, case):
    """Both kernels: all-EMPTY rows, c = 0, ragged k and c, matches whose count
    is 0 (matched_s from the flag, not the sum), sums that wrap, distinct ids."""
    b, k, c, kw = 3, 333, 777, {}
    if case == "c0":
        c = 0
    elif case == "zero_counts":
        kw = dict(count_lo=0, count_hi=2)
    elif case == "wrap":
        top = 2**31 - 1 if dtype == torch.int32 else 2**63 - 1
        kw = dict(id_range=40, count_lo=top // 2, count_hi=top)
    elif case == "distinct":
        kw = dict(id_range=2**31 - 1)
    args = combine_case(rng, b, k, c, dtype, with_errors, cuda, **kw)
    if case == "all_empty_rows":
        args[0][0] = -1
        args[1][1] = -1
    assert_combine_equals_plain(args, kernel)


@pytest.mark.parametrize("dtype,with_errors", [(torch.int32, False), (torch.int32, True),
                                               (torch.int64, False), (torch.int64, True)])
def test_combine_kernel_on_both_sides_of_the_table_limit(cuda, rng, dtype, with_errors):
    """The largest k whose table fits takes the hash kernel, the next the dense one."""
    k = max(k for k in (2048, 4096, 8192, 16384) if ss_combine.hash_fits(k, dtype, with_errors))
    assert not ss_combine.hash_fits(k + 1, dtype, with_errors)
    for kk in (k, k + 1):
        args = combine_case(rng, 2, kk, 3000, dtype, with_errors, cuda, id_range=2 * kk)
        assert ss_combine.kernel_for(2, kk, 3000, dtype, with_errors) == \
            ("hash" if kk == k else "dense")
        assert_combine_equals_plain(args)
    with pytest.raises(ValueError, match="shared memory"):
        ss_combine._combine_match(*combine_case(rng, 1, k + 1, 8, dtype, with_errors, cuda),
                                  "hash")


@pytest.mark.parametrize("kernel", ["hash", "dense"])
def test_combine_kernels_above_65535_batch_entries(cuda, rng, kernel):
    args = combine_case(rng, 65537, 16, 16, torch.int32, True, cuda, id_range=24)
    assert_combine_equals_plain(args, kernel)


@pytest.mark.parametrize("kernel", [None, "hash", "dense"])
def test_query_kernel_above_65535_batch_entries(cuda, rng, kernel):
    """The shape rule (the hash kernel at k 16) and each variant forced."""
    s = ids(rng, (65537, 16), 24, cuda)
    sc = torch.randint(1, 1 << 20, (65537, 16), dtype=torch.int32, device=cuda)
    qs = ids(rng, (65537, 16), 24, cuda)
    before = ss_query.LAUNCHES
    got = ss_query._query(s, sc, sc // 3, qs, kernel)
    torch.cuda.synchronize()
    assert ss_query.LAUNCHES == before + 1
    for a, b in zip(got, ref.query_ref(s, sc, sc // 3, qs), strict=True):
        assert torch.equal(a, b)


def test_engine_of_65537_tenants_on_card(cuda, rng):
    """impl='cuda' at 65 537 tenants (k 16, chunk 16, depth 1) equals 'sorted'."""
    stream = torch.from_numpy(rng.integers(0, 40, (65537, 48)).astype(np.int32))
    snaps = {}
    before = ss_combine.LAUNCHES
    for impl in ("cuda", "sorted"):
        e = SketchEngine(EngineConfig(k=16, tenants=65537, chunk=16, buffer_depth=1,
                                      kernel=impl))
        snaps[impl] = e.snapshot(e.ingest(e.init(), stream))
    assert ss_combine.LAUNCHES > before
    for a, b in zip(snaps["cuda"].summary, snaps["sorted"].summary, strict=True):
        assert torch.equal(a, b)
    assert int(snaps["cuda"].n) == stream.numel()


def test_match_weights_auto_above_the_table_limit_on_card(cuda, rng):
    """At k 8193 'auto' and 'cuda' launch a kernel (the dense compare: the
    hash table does not fit) and equal the plain version."""
    k = 8193
    s = torch.stack([torch.randperm(4 * k, device=cuda)[:k] for _ in range(2)]).to(torch.int32)
    s[:, ::9] = -1
    h, w = match_case(rng, 2, 5000, k, torch.int32, cuda, id_range=4 * k)[1:]
    assert ops.resolve_impl("update", k, cuda) == "cuda"
    assert ss_combine.kernel_for(2, k, 5000, torch.int32, False) == "dense"
    want = ref.match_weights_ref(s, h, w)
    for impl in ("auto", "cuda"):
        before = ss_match.LAUNCHES
        got = ops.match_weights(s, h, w, impl=impl)
        torch.cuda.synchronize()
        assert ss_match.LAUNCHES == before + 1
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)


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


def query_case(rng, b, k, q, dtype, device, *, id_range=300, count_lo=0,
               count_hi=1 << 20):
    """Summary ids with duplicates and EMPTY, counts and errors in
    [count_lo, count_hi), and queries with EMPTY and ids the rows lack."""
    s, qs = ids(rng, (b, k), id_range, device), ids(rng, (b, q), id_range + 2, device)
    sc, se = (torch.from_numpy(rng.integers(count_lo, count_hi, (b, k))).to(device=device,
                                                                          dtype=dtype)
              for _ in range(2))
    return s, sc, se, qs


def assert_query_equals_plain(args, kernel=None):
    before = ss_query.LAUNCHES
    got = ss_query._query(*args, kernel)
    torch.cuda.synchronize()
    assert ss_query.LAUNCHES == before + 1
    for a, b in zip(got, ref.query_ref(*args), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["hash", "dense"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["small_rows", "ragged", "empty", "duplicates",
                                  "zero_counts", "wrap", "distinct", "k0", "many_slices"])
def test_query_kernels_on_edge_cases(cuda, rng, kernel, dtype, case):
    """Every variant, forced at shapes the rule gives it and at shapes it
    gives another: rows of 24 ids, ragged k and q, an all-EMPTY row and a
    row of EMPTY queries, duplicate ids, counts of 0, sums that wrap,
    distinct ids, k = 0, and queries over several blocks a row."""
    b, k, q, kw = 3, 333, 777, {}
    if case == "small_rows":
        b, k, q = 5, 24, 300
    elif case in ("duplicates", "zero_counts", "wrap"):
        kw = dict(id_range=40)
        if case == "zero_counts":
            kw.update(count_lo=0, count_hi=2)
        elif case == "wrap":
            top = 2**31 - 1 if dtype == torch.int32 else 2**63 - 1
            kw.update(count_lo=top // 2, count_hi=top)
    elif case == "distinct":
        kw = dict(id_range=2**31 - 3)
    elif case == "k0":
        k = 0
    elif case == "many_slices":
        b, k, q = 2, 100, 5000
    args = query_case(rng, b, k, q, dtype, cuda, **kw)
    if case == "empty":
        args[0][0] = -1
        args[3][1] = -1
    assert_query_equals_plain(args, kernel)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_query_kernel_on_both_sides_of_the_table_limit(cuda, rng, dtype):
    """The largest k whose table fits takes the hash kernel, the next the
    dense one; forcing the hash kernel above the limit raises."""
    k = max(k for k in (2048, 4096, 8192, 16384) if ss_query.hash_fits(k, dtype))
    assert not ss_query.hash_fits(k + 1, dtype)
    for kk in (k, k + 1):
        args = query_case(rng, 2, kk, 3000, dtype, cuda, id_range=2 * kk)
        assert ss_query.kernel_for(2, kk, 3000, dtype) == ("hash" if kk == k else "dense")
        assert_query_equals_plain(args)
    with pytest.raises(ValueError, match="shared memory"):
        ss_query._query(*query_case(rng, 1, k + 1, 8, dtype, cuda), "hash")


def match_case(rng, b, k, c, dtype, device, *, id_range=60, w_lo=1, w_hi=100):
    """JAX-style inputs: summary ids with duplicates and EMPTY, histogram
    ids with duplicates and EMPTY too, weights in [w_lo, w_hi)."""
    s = ids(rng, (b, k), id_range, device)
    h = ids(rng, (b, c), id_range, device)
    w = torch.from_numpy(rng.integers(w_lo, w_hi, (b, c))).to(device=device, dtype=dtype)
    return s, h, w


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,k,c", [(1, 1, 1), (1, 100, 57), (3, 2048, 8192), (2, 700, 0),
                                   (2, 0, 33), (4, 8192, 5000), (2, 8193, 3000)])
def test_match_kernel_equals_plain(cuda, rng, dtype, b, k, c):
    """Duplicate and EMPTY ids on both sides, ragged and empty shapes, the
    largest k of the hash join and the least of the dense compare."""
    s, h, w = match_case(rng, b, k, c, dtype, cuda, id_range=max(60, k // 2))
    if dtype == torch.int64:
        w += 1 << 33
    before = ss_match.LAUNCHES
    got = ss_match.match_weights(s, h, w)
    torch.cuda.synchronize()
    assert ss_match.LAUNCHES == before + 1
    for a, want in zip(got, ref.match_weights_ref(s, h, w), strict=True):
        assert a.dtype == want.dtype and torch.equal(a, want)


def test_match_kernel_at_flush_histogram_shape(cuda, rng):
    """B 64, k 2048, c 16 384: summaries against the histograms of their windows."""
    s, h, w = match_case(rng, 64, 2048, 16384, torch.int32, cuda, id_range=20000)
    got = ss_match.match_weights(s, h, w)
    for i in range(0, 64, 8):
        want = ref.match_weights_ref(s[i:i + 8], h[i:i + 8], w[i:i + 8])
        for a, b in zip(got, want):
            assert torch.equal(a[i:i + 8], b)


def test_match_kernel_sums_wrap_and_match_sorted(cuda, rng):
    """int32 sums that wrap; on distinct summary ids the sorted plain version agrees."""
    s, h, w = match_case(rng, 2, 2048, 8192, torch.int32, cuda, id_range=40,
                         w_lo=2**29, w_hi=2**31 - 1)
    for a, want in zip(ss_match.match_weights(s, h, w), ref.match_weights_ref(s, h, w)):
        assert torch.equal(a, want)
    distinct = torch.stack([torch.randperm(4096, device=cuda)[:2048] for _ in range(2)])
    distinct = distinct.to(torch.int32)
    distinct[:, ::7] = -1
    h2 = torch.stack([torch.randperm(8192, device=cuda)[:8192] for _ in range(2)]).to(torch.int32)
    for a, want in zip(ops.match_weights(distinct, h2, w, impl="cuda"),
                       ref.match_weights_sorted(distinct, h2, w)):
        assert torch.equal(a, want)
    big = ids(rng, (1, 8193), 50, cuda)                # the dense route
    for a, want in zip(ss_match.match_weights(big, h[:1], w[:1]),
                       ref.match_weights_ref(big, h[:1], w[:1])):
        assert torch.equal(a, want)


def test_tune_cli_checks_on_card(cuda, tmp_path):
    """The tune CLI measures a plan on the card, passes --check, and 'auto' follows it."""
    from repro_torch.launch import tune
    out = tmp_path / "plan.json"
    before = ss_match.LAUNCHES
    rc = tune.main(["--check", "--no-reductions", "--ops", "update,combine,query,flush",
                    "--kernels", "torch,sorted,cuda", "--k", "256,1024",
                    "--chunks", "512,2048", "--cache-dir", str(tmp_path / "plans"),
                    "--out", str(out)])
    assert rc == 0
    assert ss_match.LAUNCHES > before
    record = json.loads(out.read_text())
    assert record["check"]["failures"] == []
    plan = ExecutionPlan.from_json(record["plan"])
    assert plan.fingerprint.startswith("cuda-") and plan.source == "measured"
    clear()
    assert active_plan("cuda") == plan
    assert active_plan("cpu").source == "static"      # a card plan never routes the CPU
    with use_plan(plan):
        cfg = EngineConfig(k=1024)
        assert cfg.resolved_kernel() == plan.impl_for("combine", 1024)
        assert cfg.resolved_flush_kernel() == plan.impl_for("flush", 1024)


def test_wrappers_refuse_mixed_devices(cuda, rng):
    s, ci = ids(rng, (64,), 50, cuda), ids(rng, (128,), 50, cuda)
    with pytest.raises(ValueError):
        ss_combine.combine_match(s, ci.cpu(), ci.cpu(), None)
    with pytest.raises(ValueError):
        ss_query.query(s, s, s, ci.cpu())
    with pytest.raises(ValueError):
        ss_match.match_weights(s, ci.cpu(), ci.cpu())
    assert ops.resolve_impl("combine", 64, cuda) == "cuda"


def summaries(rng, b, k, fill, dtype, device, *, count_hi=1 << 20, id_range=None):
    """(B, k) summaries: distinct ids in a random ``fill`` share of the slots."""
    id_range = id_range or 8 * k
    n = int(k * fill)
    items = np.full((b, k), -1, np.int32)
    counts = np.zeros((b, k), np.int64)
    for i in range(b):
        slots = rng.permutation(k)[:n]
        items[i, slots] = rng.choice(id_range, n, replace=False)
        counts[i, slots] = rng.integers(1, count_hi, n)
    if dtype == torch.int64:
        counts[counts > 0] += 1 << 33
    counts = torch.from_numpy(counts).to(device=device, dtype=dtype)
    return torch.from_numpy(items).to(device), counts, counts // 4


def assert_kernel_equals_plain(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,k,w,fill", [
    (1, 1, 1, 1.0), (3, 300, 100, 0.6), (2, 300, 0, 0.6), (2, 1000, 5000, 0.0),
    (5, 64, 4096, 1.0), (4, ss_ingest.MAX_K, ss_ingest.MAX_W, 1.0)])
def test_fused_ingest_kernel_equals_plain(cuda, rng, dtype, b, k, w, fill):
    """Ragged shapes, W < k, W = 0, the largest k and W; row 0 all EMPTY."""
    s = summaries(rng, b, k, fill, dtype, cuda)
    win = torch.from_numpy(np.minimum(rng.zipf(1.2, (b, w)), 8 * k).astype(np.int32))
    win[torch.rand(b, w) < 0.1] = -1
    win[0] = -1
    win = win.to(cuda)
    before = ss_ingest.INGEST_LAUNCHES
    got = ss_ingest.fused_ingest(*s, win)
    assert ss_ingest.INGEST_LAUNCHES == before + 1
    assert_kernel_equals_plain(got, ref.fused_ingest_ref(*s, win))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,k,fills", [
    (1, 1, (1.0, 1.0)), (3, 300, (1.0, 0.3)), (4, 700, (0.0, 0.5)),
    (2, ss_ingest.MAX_K, (1.0, 1.0)), (2, ss_ingest.MAX_K, (0.6, 0.0))])
def test_fused_combine_kernel_equals_plain(cuda, rng, dtype, b, k, fills):
    """Ragged shapes and the largest k; the two summaries share ids."""
    s1 = summaries(rng, b, k, fills[0], dtype, cuda, id_range=2 * k)
    s2 = summaries(rng, b, k, fills[1], dtype, cuda, id_range=2 * k)
    before = ss_ingest.COMBINE_LAUNCHES
    got = ss_ingest.fused_combine(*s1, *s2)
    assert ss_ingest.COMBINE_LAUNCHES == before + 1
    assert_kernel_equals_plain(got, ref.fused_combine_ref(*s1, *s2))


def test_fused_kernels_on_ties_and_wrapped_counts(cuda, rng):
    """Tied counts (the pool order decides) and int32 counts that wrap."""
    k, w = 2048, 16384
    s = summaries(rng, 4, k, 1.0, torch.int32, cuda, count_hi=4, id_range=8000)
    win = torch.from_numpy(rng.integers(0, 6000, (4, w)).astype(np.int32)).to(cuda)
    assert_kernel_equals_plain(ss_ingest.fused_ingest(*s, win), ref.fused_ingest_ref(*s, win))
    s2 = summaries(rng, 4, k, 0.8, torch.int32, cuda, count_hi=4, id_range=8000)
    assert_kernel_equals_plain(ss_ingest.fused_combine(*s, *s2), ref.fused_combine_ref(*s, *s2))
    big = (s[0], s[1] + (2**31 - 5), s[2])            # sums wrap to negative counts
    assert_kernel_equals_plain(ss_ingest.fused_ingest(*big, win),
                               ref.fused_ingest_ref(*big, win))
    for other in (s2, big):
        assert_kernel_equals_plain(ss_ingest.fused_combine(*big, *other),
                                   ref.fused_combine_ref(*big, *other))


def radix_case(rng, case, dtype, device):
    """Summaries and windows that reach each path of the radix sorts of
    ``fused_ingest_kernel`` (the window's and the winners')."""
    b, k, w = 2, 2048, 16384
    count_hi, offset, id_range = 1 << 20, 0, None
    if case == "big_counts":                      # every count above 2^24 / 2^32,
        count_hi = 40                             # ties that differ in low digits only
        offset = 2**24 + 5 if dtype == torch.int32 else 2**32 + 5
    if case in ("big_ids", "largest"):
        id_range = 2**31 - 1
    if case == "ragged":
        k, w = 1000, 12345                        # W not a power of two
    s = list(summaries(rng, b, k, 1.0, dtype, device, count_hi=count_hi, id_range=id_range))
    s[1][s[0] >= 0] += offset
    s[2] = s[1] // 4
    items = s[0].cpu().numpy()
    if case in ("big_ids", "largest"):            # ids up to 2^31 - 1, other negative ids
        win = rng.integers(-2**31, 2**31, (b, w)).astype(np.int32)
        win[:, ::5] = -1
        win[:, 1::11] = 2**31 - 1
        win[1, : w // 2] = items[1, rng.integers(0, k, w // 2)]
    elif case == "high_digits_constant":          # ids < 2^16, no EMPTY: two skipped digits
        win = rng.integers(0, 1 << 16, (b, w)).astype(np.int32)
        win[1, ::2] = items[1, rng.integers(0, k, w // 2)] & 0xFFFF
    elif case == "all_digits_vary":               # EMPTY beside ids above 2^24
        win = rng.integers(1 << 24, 1 << 30, (b, w)).astype(np.int32)
        win[rng.random((b, w)) < 0.3] = -1
    elif case == "all_equal":
        win = np.full((b, w), 7, np.int32)
        win[1] = items[1, 3]
    elif case == "all_distinct":
        win = np.stack([rng.permutation(8 * k)[:w] for _ in range(b)]).astype(np.int32)
    else:                                         # big_counts, ragged: a zipf window
        win = np.minimum(rng.zipf(1.2, (b, w)), 8 * k).astype(np.int32)
        win[rng.random((b, w)) < 0.1] = -1
    return tuple(s), torch.from_numpy(win).to(device)


RADIX_CASES = [(case, dtype) for case in ("big_ids", "high_digits_constant",
                                           "all_digits_vary", "ragged", "all_equal",
                                           "all_distinct", "big_counts")
               for dtype in (torch.int32, torch.int64)] + [("largest", torch.int64)]


@pytest.mark.parametrize("case,dtype", RADIX_CASES)
def test_fused_ingest_radix_sorts_equal_plain(cuda, rng, case, dtype):
    """The window's and the winners' radix sorts: skipped and varying digits,
    signed order over the whole int32 range, ragged W, ties in low digits,
    and the largest shape at int64 (the most shared memory)."""
    s, win = radix_case(rng, case, dtype, cuda)
    assert_kernel_equals_plain(ss_ingest.fused_ingest(*s, win),
                               ref.fused_ingest_ref(*s, win))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_fused_combine_winners_sort_on_big_counts(cuda, rng, dtype):
    """COMBINE takes the same winners' sort: counts above 2^24 / 2^32 whose
    ties differ in low digits only."""
    offset = 2**24 + 5 if dtype == torch.int32 else 2**32 + 5
    pair = []
    for fill in (1.0, 0.7):
        items, counts, _ = summaries(rng, 3, 2048, fill, dtype, cuda, count_hi=40,
                                     id_range=4096)
        counts[items >= 0] += offset
        pair += [items, counts, counts // 4]
    assert_kernel_equals_plain(ss_ingest.fused_combine(*pair),
                               ref.fused_combine_ref(*pair))


def test_fused_wrappers_refuse_above_their_limits(cuda, rng):
    s = summaries(rng, 1, ss_ingest.MAX_K + 1, 0.5, torch.int32, cuda)
    win = torch.full((1, 8), -1, dtype=torch.int32, device=cuda)
    before = (ss_ingest.INGEST_LAUNCHES, ss_ingest.COMBINE_LAUNCHES)
    with pytest.raises(ValueError, match=f"k <= {ss_ingest.MAX_K}"):
        ss_ingest.fused_ingest(*s, win)
    with pytest.raises(ValueError, match=f"k <= {ss_ingest.MAX_K}"):
        ss_ingest.fused_combine(*s, *s)
    s = summaries(rng, 1, 64, 0.5, torch.int32, cuda)
    with pytest.raises(ValueError, match=f"W <= {ss_ingest.MAX_W}"):
        ss_ingest.fused_ingest(*s, torch.full((1, ss_ingest.MAX_W + 1), -1,
                                              dtype=torch.int32, device=cuda))
    assert (ss_ingest.INGEST_LAUNCHES, ss_ingest.COMBINE_LAUNCHES) == before


def test_engine_cuda_equals_sorted_on_card(cuda, rng):
    stream = torch.from_numpy(np.minimum(rng.zipf(1.2, (8, 5000)), 10**5)
                              .astype(np.int32))
    out = {}
    launches = ss_ingest.INGEST_LAUNCHES, ss_ingest.COMBINE_LAUNCHES
    for impl in ("cuda", "sorted", "fused"):
        e = SketchEngine(EngineConfig(k=256, tenants=8, chunk=512, buffer_depth=4,
                                      kernel=impl))
        st = e.ingest(e.init(), stream)
        out[impl] = (e.snapshot(st), e.estimate(st, stream[0, :100]))
    assert ss_ingest.INGEST_LAUNCHES > launches[0]
    assert ss_ingest.COMBINE_LAUNCHES > launches[1]
    ss, es = out["sorted"]
    for impl in ("cuda", "fused"):
        sc, ec = out[impl]
        for a, b in zip(sc.summary, ss.summary):
            assert torch.equal(a, b)
        for a, b in zip(ec, es):
            assert torch.equal(a, b)


def test_main_path_cell_on_card(cuda):
    cells = []
    for impl in ("cuda", "sorted", "fused"):
        cell, snap = run_cell(n=200_000, skew=1.1, k=256, impl=impl, tenants=8,
                              buffer_depth=8, chunk=2048, device="cuda")
        cells.append((cell, snap))
    for cell, snap in cells[::2]:
        for a, b in zip(snap.summary, cells[1][1].summary):
            assert torch.equal(a, b)
    assert check_record({"cells": [c for c, _ in cells]}) == []


# -- the runtime: pinned staging on a side stream ------------------------------

def _runtime_on_card(kernel, depth=None, lanes=64, k=2048, chunk=2048, buffer_depth=8):
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    return StreamRuntime(RuntimeConfig(
        engine=EngineConfig(k=k, tenants=lanes, chunk=chunk, buffer_depth=buffer_depth,
                            kernel=kernel), shards=1, feed_depth=depth))


def _host_stream(n, seed):
    from repro_torch.data.synthetic import zipf_stream
    return zipf_stream(n, 1.1, seed=seed, max_id=10**6)


@pytest.mark.parametrize("depth", [1, 2])
def test_stager_waits_for_copies_in_flight(cuda, depth):
    """The copies are held back behind a sleep on the stager's side stream:
    a slot written again before its copy lands, or a consumer that did not
    wait for the copy, would read another block's ids."""
    from repro_torch.runtime import DeviceStager
    blocks = [np.full((64, 1 << 16), i, np.int32) for i in range(4)]
    stager = DeviceStager(device=cuda, depth=depth)
    got = []
    for b in blocks:
        with torch.cuda.stream(stager._stream):
            torch.cuda._sleep(20_000_000)               # ~10 ms of a busy side stream
        stager.stage(b)
        if not stager.room:
            got.append(stager.take()[0].clone())        # read on the current stream
    while len(stager):
        got.append(stager.take()[0].clone())
    torch.cuda.synchronize()
    for i, t in enumerate(got):
        assert bool((t == i).all()), f"block {i} was overwritten or read early"


@pytest.mark.parametrize("kernel", ["cuda", "fused"])
def test_feed_at_every_depth_equals_ingest_on_card(cuda, kernel):
    """6 host blocks of 2^22 ids (16 MiB copies) from a mid-window state."""
    from repro_torch.engine import state_to_numpy
    from repro_torch.runtime import host_blocks
    blocks = [_host_stream(1 << 22, seed=10 + i) for i in range(6)]
    rt = _runtime_on_card(kernel)
    st0 = rt.ingest(rt.init(), _host_stream(64 * 2048 * 3, seed=1))
    assert st0.fill == 3
    before = state_to_numpy(st0)
    seq = rt.ingest(rt.init(), _host_stream(64 * 2048 * 3, seed=1))
    for b in blocks:
        seq = rt.ingest(seq, torch.from_numpy(host_blocks(b, rt.workers, 2048)).to(cuda))
    want = state_to_numpy(seq)
    for depth in (1, 2, 4):
        fed = _runtime_on_card(kernel, depth).feed(st0, iter(blocks))
        for a, b in zip(state_to_numpy(fed), want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(before, state_to_numpy(st0)):       # the caller's state survives
        np.testing.assert_array_equal(a, b)


def test_runtime_cuda_equals_sorted_on_card(cuda):
    from repro_torch.core.parallel import block_decompose
    from repro_torch.core.spacesaving import prune
    from repro_torch.runtime import frequent_items
    blocks = [_host_stream(1 << 20, seed=20 + i) for i in range(4)]
    snaps = {}
    for kernel in ("cuda", "sorted", "auto"):
        rt = _runtime_on_card(kernel, 2, lanes=16, k=512, chunk=1024, buffer_depth=4)
        snaps[kernel] = rt.snapshot(rt.feed(rt.init(), iter(blocks)))
    for kernel in ("cuda", "auto"):
        for a, b in zip(snaps[kernel].summary, snaps["sorted"].summary):
            assert torch.equal(a, b)
        assert int(snaps[kernel].n) == 4 << 20
    got = frequent_items(blocks[0], k_majority=512, counters=512, p=64, chunk_size=1024)
    eng = SketchEngine(EngineConfig(k=512, tenants=64, chunk=1024, buffer_depth=1,
                                    kernel="sorted"))
    one = torch.from_numpy(blocks[0]).to(cuda)
    want = prune(eng.merged(eng.ingest(eng.init(), block_decompose(one, 64, 1024))),
                 one.numel(), 512)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the serving tier on the card ---------------------------------------------

def _serve_config(rt, tmp_path, **kw):
    from repro_torch.serve import ServeConfig
    kw.setdefault("publish_every", 4)
    kw.setdefault("ring_depth", 4)
    return ServeConfig(runtime=rt.config, flight_path=str(tmp_path / "flight.json"),
                       sample_interval_s=0.02, **kw)


def _slow_publishes(rt, cycles):
    """Make ``rt.snapshot`` publish through tensors that hold -7 until a
    sleep of ``cycles`` on the publishing stream has passed, and only then
    the snapshot's bits: a reader that does not wait for the publish reads
    -7."""
    from repro_torch.core.spacesaving import Summary
    from repro_torch.service.snapshot import publish
    plain = rt.snapshot

    def slow(state, **kw):
        snap = plain(state, **kw)
        src = (*snap.summary, snap.n, snap.shard_n)
        out = [torch.full_like(t, -7) for t in src]
        torch.cuda._sleep(cycles)
        for o, t in zip(out, src):
            o.copy_(t)
        return publish(Summary(*out[:3]), out[3], out[4], version=snap.version,
                       kernel=snap.kernel)

    rt.snapshot = slow


@pytest.mark.parametrize("kernel", ["cuda", "fused"])
def test_serve_readers_wait_for_the_publish(cuda, tmp_path, kernel):
    """The ingest loop publishes on its own stream; a reader on the default
    stream must see the published bits, not what the stream had not yet
    written (each publish is held back ~0.1 s behind a sleep)."""
    from repro_torch.runtime import host_blocks
    from repro_torch.serve import FencedSnapshot, ServingTier
    rt = _runtime_on_card(kernel, lanes=16, k=512, chunk=1024, buffer_depth=4)
    blocks = [_host_stream(16 * 1024 * 4, seed=30 + i) for i in range(3)]
    state = rt.init()
    for b in blocks:
        state = rt.ingest(state, host_blocks(b, rt.workers, 1024))
    want = rt.snapshot(state)
    _slow_publishes(rt, 200_000_000)
    with ServingTier(_serve_config(rt, tmp_path, publish_every=64), runtime=rt) as tier:
        for b in blocks:
            tier.submit(b)
        snap = tier.drain()
        assert isinstance(snap, FencedSnapshot) and snap.stream != torch.cuda.current_stream()
        got = [t.cpu() for t in snap.summary]           # read at once, on this stream
        top = tier.frontend.top_table(5)
    for a, b in zip(got, want.summary):
        assert torch.equal(a, b.cpu())
    assert top.n == int(want.n) == 3 * 16 * 1024 * 4
    assert [r["item"] for r in top.rows] == [
        int(i) for i in want.summary.items[torch.argsort(
            want.summary.counts, descending=True, stable=True)[:5]]]


@pytest.mark.parametrize("kernel,coalesce,lazy", [
    ("cuda", 1, False), ("fused", 4, True), ("auto", 1, False), ("auto", 8, True)])
def test_serve_tier_equals_sync_ingest_on_card(cuda, tmp_path, kernel, coalesce, lazy):
    """Readers query throughout; the drained snapshot equals the runtime's
    synchronous ingest of the same blocks, and a lazy snapshot held across
    later ingests equals the eager one of its position."""
    import threading

    from repro_torch.runtime import host_blocks
    from repro_torch.serve import ServingTier
    rt = _runtime_on_card(kernel, lanes=16, k=512, chunk=1024, buffer_depth=4)
    blocks = [_host_stream(16 * 1024 * 4, seed=40 + i) for i in range(12)]
    prefix = rt.init()
    for b in blocks[:5]:
        prefix = rt.ingest(prefix, host_blocks(b, rt.workers, 1024))
    want_prefix = rt.snapshot(prefix)
    state = prefix
    for b in blocks[5:]:
        state = rt.ingest(state, host_blocks(b, rt.workers, 1024))
    want = rt.snapshot(state)
    stop = threading.Event()
    cfg = _serve_config(rt, tmp_path, publish_every=2, coalesce_max=coalesce,
                        lazy_publish=lazy)
    with ServingTier(cfg, runtime=rt) as tier:

        def read():
            while not stop.is_set():
                tier.frontend.k_majority_report(64)
                tier.frontend.estimate(np.arange(16, dtype=np.int32))

        readers = [threading.Thread(target=read) for _ in range(2)]
        for t in readers:
            t.start()
        for b in blocks[:5]:
            tier.submit(b)
        held = tier.drain()
        for b in blocks[5:]:
            tier.submit(b)
        snap = tier.drain()
        stop.set()
        for t in readers:
            t.join()
    for a, b in zip(snap.summary, want.summary):
        assert torch.equal(a, b)
    for a, b in zip(held.summary, want_prefix.summary):     # materialized only now if lazy
        assert torch.equal(a, b)
    assert int(snap.n) == 12 * 16 * 1024 * 4


def test_bench_serve_gates_on_card(cuda, tmp_path):
    """A short run_bench under auto and cuda, held against sorted: every
    bitwise, accounting, health and flight-record gate holds (timings are
    not gated here)."""
    from repro_torch.launch import bench_serve
    record = bench_serve.run_bench(
        impls=["auto", "cuda"], k=512, lanes=16, chunk=1024, depth=4, blocks=12,
        layers=4, publish_every=4, ring_depth=4, queue_depth=8, admission="block",
        readers=2, qps=200.0, kmaj=64, pipeline_blocks=8, reference_impl="sorted",
        flight_dir=str(tmp_path))
    failures = bench_serve.check_record(record, min_ratio=0.0, p50_slo=float("inf"),
                                        p99_slo=float("inf"))
    assert not failures, failures
    assert record["summary"]["all_equivalent"]


def test_serving_probes_on_card(cuda, monkeypatch):
    """The publish, pipeline and reduction probes on the card: rows with
    positive times, p clipped to the card count, the warmed states intact."""
    from repro_torch.plan import probe
    kept = []
    real = probe._warmed

    def spy(rt, stream):
        st = real(rt, stream)
        kept.append((st, [t.clone() for t in (*st.summary, st.buffer, st.n)]))
        return st

    monkeypatch.setattr(probe, "_warmed", spy)
    geometry = dict(lanes=16, chunk=1024, depth=4, impl="cuda", repeat=1, device="cuda")
    pub = probe.probe_publish(ks=(256,), **geometry)
    pipe = probe.probe_pipeline(k=256, coalesce=(1, 2), feed_depths=(1, 2), **geometry)
    red = probe.probe_reductions(ps=(1, 2), k=256, n=1 << 16, **geometry)
    assert pub[0]["publish_per_step"] > 0 and len(pipe) == 5
    assert {r["p"] for r in red} == {p for p in (1, 2) if p <= torch.cuda.device_count()}
    assert all(r["time_s"] > 0 for r in red)
    for st, before in kept:
        for a, b in zip((*st.summary, st.buffer, st.n), before):
            assert torch.equal(a, b)


def test_scale_sweep_at_p1_on_card(cuda):
    from repro_torch.launch import scale
    record = scale.run_sweep(ps=[1], strategies=["butterfly", "allgather"],
                             impls=["cuda", "auto"], n=1 << 20, k=512, lanes=16, chunk=1024,
                             depth=4, repeat=1, device="cuda")
    assert scale.check_record(record) == []
    assert record["summary"]["all_equivalent"] is True
    assert record["config"]["backend"] == "cuda"


def test_bench_obs_gates_on_card(cuda, tmp_path):
    """Every obs gate but the overhead ratio (a timing) holds on the card."""
    from repro_torch.launch import bench_obs
    record = bench_obs.run_bench(impl="auto", k=256, lanes=2, chunk=512, depth=2, blocks=16,
                                 layers=8, publish_every=2, ring_depth=4, reps=1,
                                 device="cuda", flight_path=str(tmp_path / "flight.json"))
    assert bench_obs.check_record(record, min_ratio=0.0) == []
    assert record["flight"]["error_type"] == "RuntimeError"


def test_lm_serve_on_card_equals_cpu(cuda):
    """chip_smoke.py phase 10's check d): a smoke arch of the dense family
    served on the card and on the CPU with the same weights at f32 (TF32
    off): logits within 1e-4 (the same f32 operations, summed in other
    orders by cuBLAS and the CPU's BLAS), the same greedy tokens, and the
    token sketch bitwise equal (``auto`` takes the CUDA kernels on the card
    and the plain versions on the CPU)."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import model as M

    cfg = get_smoke_arch("qwen2.5-14b")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card_model = M.build_params(cfg, cuda)
        card_model.load_state_dict(cpu_model.state_dict())
        kw = dict(batch=4, prompt_len=32, gen=16, report_every=8, k_majority=16)
        on_cpu = run_serve(cfg, device="cpu", model=cpu_model, **kw)
        before = ss_combine.LAUNCHES
        on_card = run_serve(cfg, device="cuda", model=card_model, **kw)
        assert ss_combine.LAUNCHES > before       # a flush every 8 steps
        both = torch.from_numpy(np.concatenate([on_cpu["prompt"], on_cpu["tokens"]], 1))
        lg_cpu, _ = M.forward(cpu_model, {"tokens": both}, cfg)
        lg_card, _ = M.forward(card_model, {"tokens": both.to(cuda)}, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert float((on_card["prefill_logits"] - on_cpu["prefill_logits"]).abs().max()) <= 1e-4
    assert float((lg_card.cpu() - lg_cpu).abs().max()) <= 1e-4
    np.testing.assert_array_equal(on_card["tokens"], on_cpu["tokens"])
    for a, b in zip(state_to_numpy(on_card["sketch"]), state_to_numpy(on_cpu["sketch"])):
        np.testing.assert_array_equal(a, b)
    t = on_card["timings"]
    assert t["prefill_ms"] > 0 and len(t["step_ms"]) == 16 and t["decode_ms_per_step"] > 0


def test_lm_train_step_on_card_equals_cpu(cuda):
    """chip_smoke.py phase 11's check b) at one step: the smoke arch's train
    step on the card and on the CPU from the same f32 weights (TF32 off):
    loss within 1e-4 and grad norm within 1e-3 relative (the same f32
    operations, summed in other orders by cuBLAS and the CPU's BLAS), params
    within 4·lr + 1e-5 (Adam's first step moves a parameter by ±lr, so a
    gradient near 0 of the other sign moves it by 2·lr); then the token
    sketch of 6 steps' batches under cuda and auto bitwise sorted's."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.engine import state_to_numpy
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import sketch as SK
    from repro_torch.train import steps as S

    cfg = get_smoke_arch("qwen2.5-14b")
    batch = TokenStream(cfg.vocab, 4, 64).next()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        cpu_model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for device in ("cpu", "cuda"):
            model = M.build_params(cfg, device)
            model.load_state_dict(cpu_model.state_dict())
            state = S.init_train_state(cfg, torch.Generator(device).manual_seed(0),
                                       ShardingPlan(cfg), device=device, model=model)
            step = S.make_train_step(cfg, ShardingPlan(cfg), device=device)
            state, m = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
            out[device] = (state, {k: float(v) for k, v in m.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_state, cpu_m), (card_state, card_m) = out["cpu"], out["cuda"]
    assert abs(card_m["loss"] / cpu_m["loss"] - 1) <= 1e-4
    assert abs(card_m["grad_norm"] / cpu_m["grad_norm"] - 1) <= 1e-3
    want = cpu_state.params.state_dict()
    for name, t in card_state.params.state_dict().items():
        assert float((t.cpu() - want[name]).abs().max()) <= 4 * cpu_m["lr"] + 1e-5, name
    for a, b in zip(state_to_numpy(card_state.token_sketch),
                    state_to_numpy(cpu_state.token_sketch)):
        np.testing.assert_array_equal(a, b)

    data = TokenStream(cfg.vocab, 4, 64)
    batches = [torch.from_numpy(data.next()["tokens"]).to(cuda) for _ in range(6)]
    states = {}
    for kernel in ("sorted", "cuda", "auto"):
        sk = dataclasses.replace(cfg.sketch, kernel=kernel)
        engine = SK.token_engine(sk, 1, device=cuda)
        st = SK.init_token_sketch(sk, 1, device=cuda)
        for tokens in batches:
            st = SK.update_token_sketch(engine, st, tokens)
        states[kernel] = state_to_numpy(st)
    for kernel in ("cuda", "auto"):
        for a, b in zip(states[kernel], states["sorted"]):
            np.testing.assert_array_equal(a, b)


def _f32_card(fn):
    """Run ``fn()`` with TF32 off, so the card's f32 products are f32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_lm_mla_serve_on_card_equals_cpu(cuda):
    """chip_smoke.py phase 12's check d): minicpm3-4b's smoke arch served on
    the card and on the CPU from the same f32 weights (TF32 off): prefill
    logits within 1e-4 (the same f32 operations, summed in other orders by
    cuBLAS and the CPU's BLAS), the same greedy tokens, the token sketch
    bitwise."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.engine import state_to_numpy
    from repro_torch.launch.serve import run_serve
    from repro_torch.models import model as M

    cfg = get_smoke_arch("minicpm3-4b")
    cpu_model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_model = M.build_params(cfg, cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    kw = dict(batch=4, prompt_len=32, gen=16, report_every=8, k_majority=16)
    on_cpu = run_serve(cfg, device="cpu", model=cpu_model, **kw)
    on_card = _f32_card(lambda: run_serve(cfg, device="cuda", model=card_model, **kw))
    assert float((on_card["prefill_logits"] - on_cpu["prefill_logits"]).abs().max()) <= 1e-4
    np.testing.assert_array_equal(on_card["tokens"], on_cpu["tokens"])
    for a, b in zip(state_to_numpy(on_card["sketch"]), state_to_numpy(on_cpu["sketch"])):
        np.testing.assert_array_equal(a, b)


def test_moe_layer_on_card_matches_dense_reference_and_repeats(cuda):
    """One MoE layer on the card at capacity factor 8 (no drops) against
    every token through its top-k experts computed densely, within 1e-4 at
    f32 (TF32 off); and two forward + backward runs give the same bits
    (no atomic float sums in the dispatch or the combine)."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    from repro_torch.models import moe

    cfg = ArchConfig(name="t", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=64, vocab=128, param_dtype="float32", compute_dtype="float32",
                     moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=32,
                                   capacity_factor=8.0))
    p = moe.MoE(cfg, dtype=torch.float32, device=cuda)
    p.init_weights(torch.Generator(cuda).manual_seed(0))
    x = torch.randn((4, 64, 64), generator=torch.Generator(cuda).manual_seed(1), device=cuda)

    def dense():
        xt = x.reshape(-1, 64)
        top_p, top_e = torch.topk(torch.softmax(xt @ p.router, -1), 4, dim=-1)
        outs = torch.stack([(torch.nn.functional.silu(xt @ p.w_gate[e]) * (xt @ p.w_up[e]))
                            @ p.w_down[e] for e in range(16)], 1)
        rows = torch.arange(xt.shape[0], device=cuda)
        return sum(top_p[:, j:j + 1] * outs[rows, top_e[:, j]] for j in range(4)).reshape(x.shape)

    y, aux = _f32_card(lambda: moe.moe_layer(p, x, cfg))
    assert float((y - _f32_card(dense)).abs().max()) <= 1e-4
    assert int(aux["expert_counts"].sum()) == 4 * 64 * 4
    runs = []
    p.requires_grad_(True)
    for _ in range(2):
        p.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        y, aux = moe.moe_layer(p, xg, cfg)
        (y.square().sum() + aux["aux_loss"]).backward()
        runs.append([y.detach(), xg.grad] + [q.grad for q in p.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_lm_moe_train_step_on_card_equals_cpu(cuda):
    """chip_smoke.py phase 13's check b) at two steps: qwen3-moe's smoke
    arch trained on the card and on the CPU from the same f32 weights (TF32
    off, lr 1e-6 so the params stay within f32 noise of each other and the
    routing agrees): losses within 1e-4 relative, ``moe_aux_loss`` finite,
    the token and expert sketches bitwise, the expert counts summing to
    tokens·top_k·layers a step."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.engine import state_to_numpy
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import ShardingPlan
    from repro_torch.train import steps as S

    cfg = get_smoke_arch("qwen3-moe-30b-a3b")
    data = TokenStream(cfg.vocab, 4, 64)
    batches = [data.next() for _ in range(2)]
    cpu_model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def train(device):
        model = M.build_params(cfg, device)
        model.load_state_dict(cpu_model.state_dict())
        plan = ShardingPlan(cfg)
        state = S.init_train_state(cfg, torch.Generator(device).manual_seed(0), plan,
                                   device=device, model=model)
        step = S.make_train_step(cfg, plan, lr_fn=adamw.cosine_schedule(1e-6, 2, 10),
                                 device=device)
        losses = []
        for host in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(device) for k, v in host.items()})
            assert bool(torch.isfinite(m["moe_aux_loss"]))
            losses.append(float(m["loss"]))
        return state, losses

    cpu_state, cpu_losses = train("cpu")
    card_state, card_losses = _f32_card(lambda: train("cuda"))
    assert max(abs(a / b - 1) for a, b in zip(card_losses, cpu_losses)) <= 1e-4
    assert int(card_state.expert_sketch.n.sum()) == 2 * 4 * 64 * cfg.moe.top_k * cfg.n_layers
    for name in ("token_sketch", "expert_sketch"):
        for a, b in zip(state_to_numpy(getattr(card_state, name)),
                        state_to_numpy(getattr(cpu_state, name))):
            np.testing.assert_array_equal(a, b)
