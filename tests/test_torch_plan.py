"""repro_torch.plan against repro.plan: the plan, the service, its threading
through ops / engine / frontend, the cost model and the probe inputs.

The port's counterparts of ``tests/test_plan.py``'s cases, with the port's
impl names (JAX 'pallas' ↔ 'cuda', 'jnp' ↔ 'torch'), plus what is new in a
process that reaches two device types: a plan made for the card leaves CPU
tensors on their own rule, and a plan that routes a CPU tensor to 'cuda'
raises. Where the JAX package computes the same thing (the static rule,
the plan JSON, the cost model, the probe inputs), both are run on the same
input and must agree exactly. Every test resolves against an empty plan
cache of its own.
"""
import functools

import numpy as np
import pytest
import torch

from repro.plan import ExecutionPlan as JPlan
from repro.plan import static_impl as jstatic_impl
from repro.plan.model import CostModel as JCostModel
from repro_torch.core.spacesaving import Summary
from repro_torch.data.synthetic import zipf_stream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.plan import (PLAN_OPS, SORTED_MIN_K, CostModel, ExecutionPlan,
                              active_plan, clear, device_fingerprint, install,
                              plan_path, planned_engine_config, resolve_impl,
                              static_impl, static_plan, use_plan)
from repro_torch.plan import service
from repro_torch.plan.fingerprint import device_type
from repro_torch.plan.probe import _probe_inputs, timeit, timeit_rounds
from repro_torch.service import QueryFrontend

torch.set_num_threads(1)

TO_PORT = {"pallas": "cuda", "jnp": "torch", "sorted": "sorted", "fused": "fused"}
CPU = "cpu"
CARD_FP = "cuda-nvidia-h100-80gb-hbm3-sm90-torch2.11"


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


def _measured(fingerprint=None, **kw):
    base = dict(
        fingerprint=fingerprint or device_fingerprint(CPU), source="measured",
        kernels={"combine": {64: "sorted", 1024: "torch"}},
        reductions={2: "allgather", 8: "hierarchical"}, pods={8: 2},
        chunk=1024, buffer_depth=4, query_min_batch=32)
    base.update(kw)
    return ExecutionPlan(**base)


# ---------------------------------------------------------------------------
# Fingerprint, plan dataclass, static rule
# ---------------------------------------------------------------------------

def test_fingerprint_is_stable_slug():
    fp = device_fingerprint(CPU)
    assert fp == device_fingerprint("cpu:0") == device_fingerprint(torch.device("cpu"))
    assert " " not in fp and fp == fp.lower()
    major_minor = ".".join(torch.__version__.split("+")[0].split(".")[:2])
    assert fp.startswith("cpu-") and fp.endswith(f"-torch{major_minor}")
    assert device_type(fp) == "cpu" and device_type(CARD_FP) == "cuda"
    assert plan_path(fp).name == f"plan-{fp}.json"


@pytest.mark.parametrize("op", PLAN_OPS)
def test_static_impl_is_jax_rule(op):
    for k in (1, 64, SORTED_MIN_K - 1, SORTED_MIN_K, SORTED_MIN_K + 1, 4096):
        assert static_impl(op, k, on_cuda=False) == TO_PORT[jstatic_impl(op, k, on_tpu=False)]
        assert static_impl(op, k, on_cuda=True) == TO_PORT[jstatic_impl(op, k, on_tpu=True)]
    with pytest.raises(ValueError):
        static_impl("merge", 64, on_cuda=False)


def test_static_plan_reproduces_the_static_rule():
    plan = static_plan(device_fingerprint(CPU))
    assert plan.source == "static"
    assert plan.impl_for("combine", SORTED_MIN_K - 1) == "torch"
    assert plan.impl_for("combine", SORTED_MIN_K) == "sorted"
    assert plan.impl_for("query", 4 * SORTED_MIN_K) == "sorted"
    assert plan.impl_for("update", 4 * SORTED_MIN_K) == "torch"
    assert "fused" not in {plan.impl_for(op, k) for op in PLAN_OPS for k in (64, 4096)}
    card = static_plan(CARD_FP)
    assert {card.impl_for(op, k) for op in PLAN_OPS for k in (64, 4096)} == {"cuda"}
    assert plan.reduction_for(1) == "local"
    assert plan.reduction_for(8) == "butterfly"
    assert plan.pods_for(8) == 1


def test_plan_validation():
    with pytest.raises(ValueError, match="source"):
        ExecutionPlan(fingerprint="x", source="guessed", kernels={}, reductions={}, pods={})
    with pytest.raises(ValueError, match="unknown plan ops"):
        ExecutionPlan(fingerprint="x", source="static", kernels={"merge": {}},
                      reductions={}, pods={})
    with pytest.raises(ValueError, match="positive"):
        ExecutionPlan(fingerprint="x", source="static", kernels={}, reductions={},
                      pods={}, chunk=0)
    for bad in ("srted", "pallas", "jnp"):       # a typo, or a JAX plan's names
        with pytest.raises(ValueError, match="unknown impl"):
            ExecutionPlan(fingerprint="x", source="measured",
                          kernels={"combine": {256: bad}}, reductions={}, pods={})


def test_plan_nearest_log_resolution():
    plan = _measured()
    assert plan.impl_for("combine", 64) == "sorted"
    assert plan.impl_for("combine", 1024) == "torch"
    assert plan.impl_for("combine", 128) == "sorted"
    assert plan.impl_for("combine", 512) == "torch"
    assert plan.impl_for("combine", 256) == "sorted"      # log tie → smaller
    assert plan.impl_for("combine", 1) == "sorted"
    assert plan.impl_for("combine", 10**6) == "torch"
    assert plan.impl_for("update", 4 * SORTED_MIN_K) == "torch"   # static
    assert plan.reduction_for(3) == "allgather"
    assert plan.reduction_for(6) == "hierarchical"
    assert plan.pods_for(8) == 2
    assert plan.pods_for(9) == 1


def test_plan_json_roundtrip_and_jax_format(tmp_path):
    plan = _measured(kernels={"combine": {64: "sorted", 1024: "torch"},
                              "flush": {64: "fused", 1024: "cuda"}})
    assert ExecutionPlan.from_json(plan.to_json()) == plan
    path = plan.save(tmp_path / "sub" / "plan.json")
    assert ExecutionPlan.load(path) == plan
    with pytest.raises(ValueError, match="format"):
        ExecutionPlan.from_json({**plan.to_json(), "format": 99})
    # the same decisions in JAX's names: the JSON differs only in the names
    from_port = {v: k for k, v in TO_PORT.items()}
    jplan = JPlan(fingerprint=plan.fingerprint, source="measured",
                  kernels={op: {k: from_port[i] for k, i in tbl.items()}
                           for op, tbl in plan.kernels.items()},
                  reductions=dict(plan.reductions), pods=dict(plan.pods),
                  chunk=1024, buffer_depth=4, query_min_batch=32)
    jj = jplan.to_json()
    jj["kernels"] = {op: {k: TO_PORT[i] for k, i in tbl.items()}
                     for op, tbl in jj["kernels"].items()}
    assert jj == plan.to_json()


# ---------------------------------------------------------------------------
# Service: precedence, per device
# ---------------------------------------------------------------------------

def test_active_plan_static_by_default():
    assert active_plan(CPU).source == "static"
    assert active_plan(CPU).fingerprint == device_fingerprint(CPU)


def test_install_beats_env_and_cache(tmp_path, monkeypatch):
    fp = device_fingerprint(CPU)
    _measured(chunk=512).save(plan_path(fp, tmp_path))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
    _measured(chunk=2048).save(tmp_path / "pinned.json")
    monkeypatch.setenv("REPRO_TORCH_PLAN_FILE", str(tmp_path / "pinned.json"))
    clear()
    assert active_plan(CPU).chunk == 2048            # env file beats cache
    with use_plan(_measured(chunk=256)):
        assert active_plan(CPU).chunk == 256         # installed beats env
    assert active_plan(CPU).chunk == 2048
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE")
    assert active_plan(CPU).chunk == 512             # cache beats static
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "empty"))
    clear()
    assert active_plan(CPU).source == "static"


def test_pinned_plan_file_must_load(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_FILE", str(tmp_path / "nope.json"))
    with pytest.raises(ValueError, match="REPRO_TORCH_PLAN_FILE"):
        active_plan(CPU)
    (tmp_path / "bad.json").write_text("{truncated")
    monkeypatch.setenv("REPRO_TORCH_PLAN_FILE", str(tmp_path / "bad.json"))
    with pytest.raises(ValueError, match="REPRO_TORCH_PLAN_FILE"):
        active_plan(CPU)


def test_foreign_fingerprint_cache_ignored(tmp_path, monkeypatch):
    _measured(fingerprint="cpu-other-torch9.9").save(
        plan_path(device_fingerprint(CPU), tmp_path))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
    clear()
    assert active_plan(CPU).source == "static"


def test_malformed_cache_falls_back(tmp_path, monkeypatch):
    path = plan_path(device_fingerprint(CPU), tmp_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("{not json")
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path))
    clear()
    assert active_plan(CPU).source == "static"
    assert active_plan(CPU).source == "static"       # negative-cached, same answer


def test_card_plan_leaves_cpu_tensors_on_their_rule(tmp_path, monkeypatch):
    """A plan measured on the card routes 'cuda' everywhere; CPU tensors
    under it (installed or pinned) keep the CPU's static rule."""
    card = _measured(fingerprint=CARD_FP, kernels={op: {64: "cuda", 2048: "cuda"}
                                                   for op in PLAN_OPS})
    s = torch.arange(64, dtype=torch.int32)
    c = torch.arange(32, 96, dtype=torch.int32)
    with use_plan(card):
        assert active_plan(CPU).source == "static"
        assert ops.resolve_impl("combine", 64, CPU) == "torch"
        assert EngineConfig(k=64, device=CPU).resolved_kernel() == "torch"
        for a, b in zip(ops.combine_match(s, c, c), tref.combine_match_ref(s, c, c)):
            assert (a is None and b is None) or torch.equal(a, b)
    card.save(tmp_path / "card.json")
    monkeypatch.setenv("REPRO_TORCH_PLAN_FILE", str(tmp_path / "card.json"))
    clear()
    assert active_plan(CPU).source == "static"
    assert ops.resolve_impl("query", 4096, CPU) == "sorted"


def test_plan_routing_cpu_to_cuda_raises():
    bad = _measured(kernels={"combine": {64: "cuda"}, "update": {64: "cuda"}})
    s = torch.arange(64, dtype=torch.int32)
    with use_plan(bad):
        with pytest.raises(ValueError, match="'cuda'"):
            ops.combine_match(s, s, s)
        with pytest.raises(ValueError, match="'cuda'"):
            ops.match_weights(s, s, s)
        with pytest.raises(ValueError, match="'cuda'"):
            EngineConfig(k=64, device=CPU).resolved_kernel()
        with pytest.raises(ValueError, match="'cuda'"):
            resolve_impl("combine", 64, CPU)


# ---------------------------------------------------------------------------
# Threading: ops / engine / frontend resolve through the plan
# ---------------------------------------------------------------------------

def test_ops_auto_routes_through_installed_plan(monkeypatch):
    calls = []
    real_sorted, real_dense = tref.combine_match_sorted, tref.combine_match_ref
    monkeypatch.setattr(tref, "combine_match_sorted",
                        lambda *a: calls.append("sorted") or real_sorted(*a))
    monkeypatch.setattr(tref, "combine_match_ref",
                        lambda *a: calls.append("torch") or real_dense(*a))
    s = torch.arange(64, dtype=torch.int32)
    c = torch.arange(64, 80, dtype=torch.int32)
    cnt = torch.ones(16, dtype=torch.int32)
    ops.combine_match(s, c, cnt)                     # static at k = 64: torch
    assert calls == ["torch"]
    gen = service.generation()
    with use_plan(_measured()):
        assert service.generation() > gen            # the ops memo is invalidated
        ops.combine_match(s, c, cnt)
    assert calls == ["torch", "sorted"]
    ops.combine_match(s, c, cnt)
    assert calls == ["torch", "sorted", "torch"]


def test_engine_config_resolves_through_plan():
    assert EngineConfig(k=64, device=CPU).resolved_kernel() == "torch"
    assert EngineConfig(k=2048, device=CPU).resolved_kernel() == "sorted"
    assert EngineConfig(k=2048, device=CPU).resolved_flush_kernel() == "sorted"
    plan = _measured(kernels={"combine": {64: "sorted", 1024: "torch"},
                              "flush": {64: "fused", 1024: "torch"}})
    with use_plan(plan):
        cfg = EngineConfig(k=64, device=CPU)
        assert (cfg.resolved_kernel(), cfg.resolved_flush_kernel()) == ("sorted", "fused")
        assert cfg.pair_fn() is not None              # a fused flush: fused tree rounds
        cfg = EngineConfig(k=2048, device=CPU)
        assert (cfg.resolved_kernel(), cfg.resolved_flush_kernel()) == ("torch", "torch")
        assert cfg.pair_fn() is None
        assert EngineConfig(k=64, kernel="torch", device=CPU).resolved_flush_kernel() == "torch"


def test_planned_engine_config():
    cfg = planned_engine_config(k=512, device=CPU)
    assert (cfg.chunk, cfg.buffer_depth, cfg.kernel, cfg.device) == (2048, 8, "auto", CPU)
    with use_plan(_measured()):
        cfg = planned_engine_config(k=512, device=CPU, tenants=4)
        assert (cfg.chunk, cfg.buffer_depth, cfg.tenants) == (1024, 4, 4)
        assert planned_engine_config(k=512, device=CPU, chunk=256).chunk == 256


# the plan measured on the H100 (PERF.md §6): the fused flush at every
# probed k, the hand-written kernels elsewhere, chunk 8192
CARD_PLAN = dict(fingerprint=CARD_FP, chunk=8192, buffer_depth=8,
                 kernels={"flush": {256: "fused", 1024: "fused", 2048: "fused"},
                          **{op: {256: "cuda", 2048: "cuda"}
                             for op in ("update", "combine", "query")}})


@pytest.mark.parametrize("k,chunk,depth,want", [
    (2048, 2048, 8, "fused"),       # W 16 384: the kernels take it
    (256, 512, 2, "fused"),
    (2048, 8192, 8, "cuda"),        # W 65 536: above the kernels' W limit
    (2048, 2048, 9, "cuda"),        # W 18 432
    (4096, 2048, 8, "cuda"),        # k snaps to the probed 2048, but is above the k limit
    (4096, 512, 2, "cuda"),
])
def test_auto_flush_takes_fused_only_where_the_kernels_fit(k, chunk, depth, want):
    """Under the card's measured plan, 'auto' keeps the flush and the COMBINE
    tree off the fused kernels at a shape they refuse: the plan's "combine"
    impl instead, and no fused pair_fn. An explicit 'fused' is never rerouted."""
    with use_plan(_measured(**CARD_PLAN)):
        cfg = EngineConfig(k=k, chunk=chunk, buffer_depth=depth)
        assert cfg.device == "cuda" and cfg.resolved_kernel() == "cuda"
        assert cfg.resolved_flush_kernel() == want
        assert (cfg.pair_fn() is not None) == (want == "fused")
        pinned = EngineConfig(k=k, chunk=chunk, buffer_depth=depth, kernel="fused")
        assert pinned.resolved_flush_kernel() == "fused" and pinned.pair_fn() is not None


def test_planned_engine_config_under_card_plan_stays_off_fused():
    """The card's plan recommends chunk 8192: its planned engine's window
    (65 536 ids) is above the fused kernel's limit, so its flush takes 'cuda'."""
    with use_plan(_measured(**CARD_PLAN)):
        cfg = planned_engine_config(2048, tenants=64)
        assert (cfg.chunk * cfg.buffer_depth, cfg.device) == (65536, "cuda")
        assert cfg.resolved_flush_kernel() == "cuda" and cfg.pair_fn() is None
        assert planned_engine_config(2048, chunk=2048).resolved_flush_kernel() == "fused"


def _window_case(rng, b, k, w):
    items = np.stack([rng.permutation(4 * k)[:k] for _ in range(b)]).astype(np.int32)
    items[:, ::5] = -1
    counts = rng.integers(1, 50, (b, k)).astype(np.int32)
    counts[items < 0] = 0
    window = rng.integers(-1, 4 * k, (b, w)).astype(np.int32)
    return tuple(torch.from_numpy(a) for a in (items, counts, counts // 3, window))


@pytest.mark.parametrize("k,w,fused", [(64, 64, True), (64, 16384, True),
                                       (64, 16385, False), (2049, 40, False)])
def test_ops_ingest_window_auto_follows_the_fit_rule(monkeypatch, rng, k, w, fused):
    """ops.ingest_window / combine_summaries under 'auto' route to the fused
    kernels (here their plain versions) only where ss_ingest.fits holds; the
    bits are the same on either route, and an explicit 'fused' is not rerouted."""
    from repro_torch.kernels import ss_ingest
    calls = []
    for name in ("fused_ingest", "fused_combine"):
        real = getattr(ss_ingest, name)
        monkeypatch.setattr(ss_ingest, name,
                            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    items, counts, errors, window = _window_case(rng, 2, k, w)
    want = ops.ingest_window(items, counts, errors, window, impl="sorted")
    want_c = ops.combine_summaries(items, counts, errors, *(a.flip(0) for a in
                                   (items, counts, errors)), impl="sorted")
    assert calls == []
    plan = _measured(kernels={"flush": {64: "fused"}, "combine": {64: "fused"}})
    with use_plan(plan):
        got = ops.ingest_window(items, counts, errors, window)
        got_c = ops.combine_summaries(items, counts, errors,
                                      *(a.flip(0) for a in (items, counts, errors)))
        assert ops.resolve_window_impl("flush", k, w, CPU) == ("fused" if fused else "sorted")
    assert calls == (["fused_ingest", "fused_combine"] if fused
                     else [] if k > 2048 else ["fused_combine"])
    for a, b in zip((*got, *got_c), (*want, *want_c)):
        assert torch.equal(a, b)
    calls.clear()
    ops.ingest_window(items, counts, errors, window, impl="fused")
    assert calls == ["fused_ingest"]


@pytest.mark.parametrize("k,kernel", [(64, "hash"), (8192, "hash"), (8193, "dense"),
                                      (20000, "dense")])
def test_match_weights_auto_takes_cuda_at_every_k(monkeypatch, rng, k, kernel):
    """On the card, ops.match_weights under 'auto' resolves to the plan's
    'update' impl at every k: the CUDA wrapper takes any k (the hash join
    where its table fits, the dense compare above), so nothing is rerouted
    to a plain version on the card. An explicit 'cuda' takes the same route."""
    from repro_torch.kernels import ss_combine, ss_match
    assert static_impl("update", k, on_cuda=True) == "cuda"
    with use_plan(_measured(**CARD_PLAN)):
        assert ops.resolve_impl("update", k, "cuda") == "cuda"
    assert ss_combine.kernel_for(2, k, 300, torch.int32, False) == kernel
    # CPU tensors routed as the card's plan routes them: the kernel's wrapper
    # then computes its plain version, so the route is visible and comparable
    calls = []
    monkeypatch.setattr(ops, "resolve_impl", lambda op, kk, dev: "cuda")
    monkeypatch.setattr(ops, "_cuda_only", lambda name, t: None)
    real_kernel, real_sorted = ss_match.match_weights, tref.match_weights_sorted
    monkeypatch.setattr(ss_match, "match_weights",
                        lambda *a: calls.append("cuda") or real_kernel(*a))
    monkeypatch.setattr(tref, "match_weights_sorted",
                        lambda *a: calls.append("sorted") or real_sorted(*a))
    s = torch.from_numpy(np.stack([rng.permutation(3 * k)[:k] for _ in range(2)])
                         .astype(np.int32))
    s[:, ::7] = -1
    h = torch.from_numpy(rng.integers(-1, 3 * k, (2, 300)).astype(np.int32))
    w = torch.from_numpy(rng.integers(1, 100, (2, 300)).astype(np.int32))
    got = ops.match_weights(s, h, w)
    assert calls == ["cuda"]
    for a, b in zip(got, tref.match_weights_ref(s, h, w), strict=True):
        assert torch.equal(a, b)
    calls.clear()
    ops.match_weights(s, h, w, impl="cuda")
    assert calls == ["cuda"]


def test_frontend_min_batch_and_queries_from_plan(monkeypatch):
    calls = []
    real_sorted, real_dense = tref.query_sorted, tref.query_ref
    monkeypatch.setattr(tref, "query_sorted",
                        lambda *a: calls.append("sorted") or real_sorted(*a))
    monkeypatch.setattr(tref, "query_ref", lambda *a: calls.append("torch") or real_dense(*a))
    summary = Summary(torch.tensor([5, 9, -1, 2], dtype=torch.int32),
                      torch.tensor([7, 3, 0, 1], dtype=torch.int32),
                      torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    queries = torch.tensor([5, 2, 7], dtype=torch.int32)
    frontend = QueryFrontend("auto")
    assert frontend.bucket_floor(CPU) == 16          # static default
    assert frontend.plan([1, 2, 3], device=CPU)[0].shape == (16,)
    want = frontend._estimate(summary, queries)      # static at k = 4: torch
    with use_plan(_measured(kernels={"query": {4: "sorted"}})):
        assert frontend.bucket_floor(CPU) == 32
        assert frontend.plan([1, 2, 3], device=CPU)[0].shape == (32,)
        assert QueryFrontend("auto", min_batch=8).bucket_floor(CPU) == 8
        got = frontend._estimate(summary, queries)
    assert calls == ["torch", "sorted"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _snap(kernel, stream):
    e = SketchEngine(EngineConfig(k=128, tenants=2, chunk=256, buffer_depth=2,
                                  kernel=kernel, device=CPU))
    return e.snapshot(e.ingest(e.init(), stream))


def test_engine_auto_under_plan_equals_every_fixed_impl():
    """'auto' under an installed plan gives the same snapshot as every impl."""
    stream = zipf_stream(12_000, 1.2, seed=1, max_id=10**5).reshape(2, -1)
    fixed = {impl: _snap(impl, stream) for impl in ("torch", "sorted", "fused")}
    for combine, flush in (("torch", "sorted"), ("sorted", "fused"), ("sorted", "torch")):
        with use_plan(_measured(kernels={"combine": {128: combine},
                                         "flush": {128: flush}})):
            auto = _snap("auto", stream)
        assert auto.kernel == combine
        for snap in fixed.values():
            for a, b in zip(auto.summary, snap.summary):
                assert torch.equal(a, b)
            assert int(auto.n) == int(snap.n)


def test_install_none_clears():
    install(_measured())
    assert active_plan(CPU).source == "measured"
    install(None)
    assert active_plan(CPU).source == "static"


# ---------------------------------------------------------------------------
# Cost model: the same numbers as the JAX package's
# ---------------------------------------------------------------------------

def _grid_rows(fn, impl="torch", ks=(64, 256, 1024), cs=(128, 512)):
    return [{"op": "combine", "impl": impl, "k": k, "c": c, "time_s": fn(k, c)}
            for k in ks for c in cs]


def test_cost_model_interpolates_power_laws():
    model = CostModel(_grid_rows(lambda k, c: 1e-9 * k * c))
    assert model.predict("combine", "torch", 256, 512) == pytest.approx(1e-9 * 256 * 512, rel=1e-6)
    assert model.predict("combine", "torch", 128, 256) == pytest.approx(1e-9 * 128 * 256, rel=0.05)
    assert model.predict("combine", "torch", 10**6, 10**6) == pytest.approx(1e-9 * 1024 * 512,
                                                                            rel=1e-6)
    with pytest.raises(ValueError, match="not complete"):
        CostModel(_grid_rows(lambda k, c: 1.0)[:-1])
    with pytest.raises(KeyError, match="not probed"):
        model.predict("query", "torch", 64, 64)


def test_cost_model_equals_jax(rng):
    """predict, choose_impl and validate on the same rows, impl names mapped."""
    rows = []
    for op in ("combine", "query"):
        for impl in ("pallas", "jnp", "sorted"):
            rows += [{**r, "op": op} for r in _grid_rows(
                lambda k, c: float(rng.uniform(1e-6, 1e-3)), impl=impl)]
    jmodel = JCostModel(rows)
    model = CostModel([{**r, "impl": TO_PORT[r["impl"]]} for r in rows])
    held = [{"op": "combine", "impl": "jnp", "k": 91, "c": 300, "time_s": 2e-4}]
    assert [v["rel_err"] for v in jmodel.validate(held)] == \
        [v["rel_err"] for v in model.validate([{**held[0], "impl": "torch"}])]
    for op in ("combine", "query"):
        for k in (1, 64, 100, 256, 700, 1024, 5000):
            for c in (16, 128, 300, 512, 9000):
                for impl in ("pallas", "jnp", "sorted"):
                    assert model.predict(op, TO_PORT[impl], k, c) == \
                        jmodel.predict(op, impl, k, c)
                assert model.choose_impl(op, k, c) == TO_PORT[jmodel.choose_impl(op, k, c)]


# ---------------------------------------------------------------------------
# Probes: the same cells as the JAX package's, and a timer that times
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", PLAN_OPS)
def test_probe_inputs_equal_jax(op):
    from repro.plan.probe import _probe_inputs as jprobe_inputs
    import jax.numpy as jnp
    for k, c in ((64, 128), (256, 512), (300, 57)):
        jargs = jprobe_inputs(op, k, c, jnp.dtype("int32"), 3)
        targs = _probe_inputs(op, k, c, "int32", 3, CPU)
        assert len(jargs) == len(targs)
        for a, b in zip(jargs, targs):
            assert b.dtype == torch.from_numpy(np.array(a)).dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    wide, narrow = (_probe_inputs(op, 64, 128, d, 3, CPU) for d in ("int64", "int32"))
    assert {a.dtype for a in wide} == {torch.int32, torch.int64}
    for a, b in zip(wide, narrow):
        assert torch.equal(a.long(), b.long())


def test_timeit_times_calls():
    calls = []
    t = timeit(lambda x: calls.append(x), torch.zeros(3), repeat=2, sample_s=1e-4)
    assert t > 0 and len(calls) >= 4


def test_timeit_rounds_alternates_the_fns():
    calls = []
    fns = {name: functools.partial(lambda n, x: calls.append(n), name)
           for name in ("a", "b")}
    times = timeit_rounds(fns, torch.zeros(3), repeat=3, sample_s=1e-4)
    assert set(times) == {"a", "b"} and all(t > 0 for t in times.values())
    # one timeit of each fn a round: the names change 2·3 − 1 times
    runs = [n for i, n in enumerate(calls) if i == 0 or calls[i - 1] != n]
    assert runs == ["a", "b"] * 3
