"""The port's tune CLI (``repro_torch.launch.tune``) on the CPU.

No test here passes or fails on a timing. The CLI runs end to end at a
tiny grid with a deterministic stand-in for the probe timer (every probed
call still runs once), which makes its plan, its tolerance gate and its
cache write a function of the synthetic times; the bitwise gate, the
probe coverage, the cache write and the pick-up of the plan by every
``'auto'`` are then checked. One run with the real timer checks everything
but the timing verdict. The choosers are held against the JAX package's
on synthetic rows, and the tolerance decision is tested on synthetic
times. What the CLI refuses (ops and probes not yet ported, shapes beyond
the fused kernel's limit on a CUDA device) raises before any probe.
"""
import functools
import json

import pytest
import torch

from repro.launch import tune as jtune
from repro.plan.model import CostModel as JCostModel
from repro_torch.engine import EngineConfig
from repro_torch.kernels import ops, ss_ingest
from repro_torch.launch import tune
from repro_torch.plan import (CostModel, ExecutionPlan, active_plan, clear,
                              device_fingerprint, plan_path)
from repro_torch.plan import probe
from repro_torch.service import QueryFrontend

torch.set_num_threads(1)

CPU_ARGS = ["--device", "cpu", "--no-reductions", "--ops", "update,combine,query,flush",
            "--kernels", "torch,sorted", "--k", "64,128", "--chunks", "128,256",
            "--repeat", "1"]
TO_PORT = {"pallas": "cuda", "jnp": "torch", "sorted": "sorted", "fused": "fused"}
#: synthetic seconds per call: a launch cost, then dense (k·c) or linear work
LAUNCH = 2e-5
COST = {"torch": lambda k, c: LAUNCH + 1e-9 * k * c,
        "sorted": lambda k, c: LAUNCH + 6.4e-8 * (k + c),
        "fused": lambda k, c: LAUNCH + 5e-8 * (k + c)}


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


@pytest.fixture
def synthetic_timer(monkeypatch):
    """``probe.timeit`` → one real call, then the synthetic time of the cell."""
    def fake(fn, *args, **_):
        fn(*args)
        k, c = args[0].shape[-1], args[-1].shape[-1]
        return COST[fn.keywords["impl"]](k, c)
    monkeypatch.setattr(probe, "timeit", fake)


def run(tmp_path, *extra):
    out = tmp_path / "plan_record.json"
    rc = tune.main([*CPU_ARGS, "--cache-dir", str(tmp_path / "plans"), "--out", str(out),
                    *extra])
    return rc, json.loads(out.read_text())


def test_cli_writes_plan_and_auto_follows_it(tmp_path, synthetic_timer):
    rc, record = run(tmp_path)
    assert rc == 0
    assert all(record["check"]["bitwise_equivalent"].values())
    assert set(record["check"]["bitwise_equivalent"]) == {
        "update:torch", "update:sorted", "combine:torch", "combine:sorted",
        "query:torch", "query:sorted", "flush:torch", "flush:sorted", "flush:fused",
        "engine:torch", "engine:sorted", "engine:fused"}
    assert record["check"]["failures"] == []
    # coverage: every (op, impl, k, c) cell, fused on the flush surface only
    cells = {(r["op"], r["impl"], r["k"], r["c"]) for r in record["probes"]}
    want = {(op, impl, k, c) for op in ("update", "combine", "query", "flush")
            for impl in ("torch", "sorted") + (("fused",) if op == "flush" else ())
            for k in (64, 128) for c in (128, 256)}
    assert cells == want and len(record["probes"]) == len(want)
    assert {(r["k"], r["c"]) for r in record["min_batch_probes"]} == \
        {(k, c) for k in (64, 128) for c in (16, 64, 256)}
    assert {v["k"] for v in record["validation"]} == {91}
    # the plan the synthetic times imply: at c = 256, dense wins at k = 64
    # and sorted at 128, fused wins the flush; the per-item combine cost
    # falls with c (chunk 256); 64 queries cost within 25% of 16 (floor 64)
    plan = ExecutionPlan.from_json(record["plan"])
    assert plan.source == "measured" and plan.fingerprint == device_fingerprint("cpu")
    assert plan.kernels["update"] == plan.kernels["combine"] == {64: "torch", 128: "sorted"}
    assert plan.kernels["flush"] == {64: "fused", 128: "fused"}
    assert plan.kernels["query"] == {64: "torch", 128: "torch"}
    assert (plan.chunk, plan.query_min_batch) == (256, 64)
    # every gate cell measured the static impl and passed with margin 1
    for g in record["check"]["tolerance_cells"]:
        assert g["static_impl"] in g["fresh_s"] and g["margin"] == 1.0
    # the cache holds it, and every 'auto' on the CPU follows it
    cache_file = plan_path(plan.fingerprint, tmp_path / "plans")
    assert record["plan_cache"] == str(cache_file)
    assert ExecutionPlan.load(cache_file) == plan
    clear()
    assert active_plan("cpu") == plan
    assert ops.resolve_impl("combine", 128, "cpu") == "sorted"
    assert ops.resolve_impl("update", 64, "cpu") == plan.kernels["update"][64]
    cfg = EngineConfig(k=64, device="cpu")
    assert (cfg.resolved_kernel(), cfg.resolved_flush_kernel()) == ("torch", "fused")
    assert cfg.pair_fn() is not None
    assert QueryFrontend().bucket_floor("cpu") == 64
    assert record["plan_resolution"]["source"] == "measured"


def test_cli_with_real_timer(tmp_path):
    """Every probe and gate runs; the verdict on CPU timings is not asserted."""
    rc, record = run(tmp_path, "--no-cache")
    assert rc == 0 and record["plan_cache"] == ""
    assert all(record["check"]["bitwise_equivalent"].values())
    assert all(r["time_s"] > 0 for r in record["probes"])
    assert len(record["check"]["tolerance_cells"]) == 4 * 2
    assert all(f.split("/")[0] in ("update", "combine", "query", "flush")
               for f in record["check"]["failures"])


def test_choosers_equal_jax(rng):
    for ks in ([64, 128], [256, 1024, 4096], [100, 300, 301, 5000]):
        assert tune._midpoints(ks) == jtune._midpoints(ks)
    rows = [{"op": op, "impl": impl, "k": k, "c": c,
             "time_s": float(rng.uniform(1e-6, 1e-3))}
            for op in ("combine", "query") for impl in ("jnp", "sorted", "pallas")
            for k in (64, 256, 1024) for c in (16, 64, 256, 512, 2048)]
    port_rows = [{**r, "impl": TO_PORT[r["impl"]]} for r in rows]
    assert tune._choose_chunk(CostModel(port_rows), [64, 256, 1024], [512, 2048]) == \
        jtune._choose_chunk(JCostModel(rows), [64, 256, 1024], [512, 2048])
    for chunk in (64, 2048):
        assert tune._choose_query_min_batch(port_rows, chunk) == \
            jtune._choose_query_min_batch(rows, chunk)
    plateau = [{"op": "query", "impl": "cuda", "k": 64, "c": c, "time_s": t}
               for c, t in ((16, 1.0), (64, 1.2), (256, 3.0))]
    assert tune._choose_query_min_batch(plateau, 2048) == 64
    assert tune._choose_query_min_batch([], 2048) == 16
    for op in ("update", "combine", "query", "flush"):
        assert tune._impls_for_op(op, ["torch", "sorted"]) == \
            [TO_PORT[i] for i in jtune._impls_for_op(op, ["jnp", "sorted"])]


def test_tolerance_decision_on_synthetic_times():
    gate = functools.partial(tune.gate_cell, "combine", 1024, 2048, tolerance=0.5)
    row, failure = gate("sorted", "cuda", {"cuda": 2.0, "sorted": 1.0, "torch": 4.0})
    assert failure is None and row["margin"] == 1.0
    assert row["best_fresh_s"] == 1.0 and row["static_fresh_s"] == 2.0
    row, failure = gate("cuda", "cuda", {"cuda": 1.5, "sorted": 1.0})
    assert failure is None and row["margin"] == 1.5          # at the limit: a pass
    row, failure = gate("cuda", "cuda", {"cuda": 1.6, "sorted": 1.0})
    assert row["margin"] == pytest.approx(1.6)
    assert failure.startswith("combine/k1024: planned cuda") and "50%" in failure
    _, failure = tune.gate_cell("query", 64, 16, "torch", "torch",
                                {"torch": 5.0, "sorted": 1.0}, 3.0)
    assert failure and "300%" in failure


def test_refusals_before_any_probe(tmp_path, monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("probed")
    monkeypatch.setattr(probe, "probe_kernels", no_probe)
    base = ["--cache-dir", str(tmp_path), "--out", str(tmp_path / "r.json")]
    for op in ("publish", "pipeline"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tune.main(["--device", "cpu", "--no-reductions", "--ops", op, *base])
    with pytest.raises(NotImplementedError, match="--no-reductions"):
        tune.main(["--device", "cpu", "--ops", "combine", *base])
    with pytest.raises(ValueError, match="needs --device cuda"):
        tune.main(["--device", "cpu", "--no-reductions", "--kernels", "cuda", *base])
    with pytest.raises(ValueError, match=f"k <= {ss_ingest.MAX_K}"):
        tune.main(["--device", "cuda", "--no-reductions", "--k", "256,4096", *base])
    with pytest.raises(ValueError, match=f"W <= {ss_ingest.MAX_W}"):
        tune.main(["--device", "cuda", "--no-reductions", "--chunks", "512,32768", *base])
    # the update surface's kernel takes any k: nothing to refuse there
    tune._check_surface(("update",), ("cuda",), (16384,), (512,), "cuda")
    with pytest.raises(ValueError, match="not in"):
        tune.main(["--device", "cpu", "--no-reductions", "--ops", "merge", *base])
    assert not (tmp_path / "r.json").exists()
