"""repro_torch.launch.bench_serve on the CPU.

A tiny ``run_bench`` through ``check_record``'s bitwise, accounting,
health and flight-record gates (its timing gates are fed with ``0`` /
``inf`` limits there, and tested on synthetic records, so that no test
passes or fails on a timing of this machine), the same run held against
the JAX package's ``run_bench`` on the same blocks (the drained sketch's
health and the admission counters), ``check_regression``'s fingerprint and
workload skips, and the CLI.
"""
import copy
import json
import math

import pytest

from repro_torch.launch import bench_serve
from repro_torch.plan import clear

# three readers: each starts on another op, so every op is read at least
# once however short the loaded phase is
TINY = dict(k=64, lanes=2, chunk=128, depth=2, blocks=6, layers=2, publish_every=2,
            ring_depth=3, queue_depth=4, admission="block", readers=3, qps=300.0,
            kmaj=16, pipeline_blocks=4)
NO_TIMING = dict(min_ratio=0.0, p50_slo=math.inf, p99_slo=math.inf)


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    kept = []
    rec = bench_serve.run_bench(impls=["torch", "sorted"], device="cpu",
                                reference_impl="sorted",
                                flight_dir=str(tmp_path_factory.mktemp("flight")),
                                keep=lambda *a: kept.append(a[:2]), **TINY)
    rec["_kept"] = kept
    return rec


def test_run_bench_passes_the_bitwise_and_accounting_gates(record):
    assert bench_serve.check_record(record, **NO_TIMING) == []
    s = record["summary"]
    assert s["all_equivalent"] and s["all_lazy_eager_equivalent"]
    for impl in ("torch", "sorted"):
        r = record["impls"][impl]
        assert r["reference_equivalent"] and r["pipeline"]["equivalent"]
        assert r["loaded"]["audit"]["health_consistent"]
        assert r["loaded"]["audit"]["flight_record_valid"]
        for phase in ("baseline", "loaded"):
            st = r[phase]["stats"]
            assert st["blocks_submitted"] == st["blocks_ingested"] == 6
            assert st["publishes"] == 5          # initial + 3 cadence + drain
        assert r["loaded"]["reads_total"] >= 1
        assert r["loaded"]["pipeline"]["sentinel_host_copies"] >= 1
    assert [k[1] for k in record["_kept"][:5]] == ["reference", "baseline", "loaded",
                                                   "legacy", "tuned"]


def test_run_bench_record_is_strict_json(record):
    clean = {k: v for k, v in record.items() if k != "_kept"}
    json.loads(json.dumps(clean))
    assert record["config"]["backend"] == "cpu"
    assert record["fingerprint"].startswith("cpu-")


def test_run_bench_equals_jax_run_bench_on_the_same_blocks(record):
    """The JAX harness on the same seeded blocks: the drained sketch's
    health and the admission/publish counters agree."""
    from repro.launch import bench_serve as jbench
    jrec = jbench.run_bench(impls=["jnp"], **TINY)
    jr, tr = jrec["impls"]["jnp"], record["impls"]["torch"]
    for phase in ("baseline", "loaded"):
        assert jr[phase]["stats"] == tr[phase]["stats"]
    assert jr["loaded"]["health"] == tr["loaded"]["health"]
    assert jr["items_total"] == tr["items_total"] and jr["block_items"] == tr["block_items"]


@pytest.mark.parametrize("edits,match", [
    ({"ingest_ratio": 0.5}, "ingest under readers"),
    ({"loaded.queries.point.p50_s": 0.9}, "p50"),
    ({"loaded.queries.top.p99_s": 9.0}, "p99"),
    ({"loaded.queries.kmaj.count": 0}, "no reads sampled"),
    ({"baseline.equivalent": False}, "baseline tier snapshot"),
    ({"loaded.equivalent": False}, "loaded tier snapshot"),
    ({"reference_equivalent": False}, "reference"),
    ({"lazy_eager_equivalent": False}, "lazy snapshot"),
    ({"pipeline.equivalent": False}, "pipeline-tuned"),
    ({"loaded.audit.health_consistent": False}, "health gauges"),
    ({"loaded.audit.flight_record_valid": False}, "flight record"),
    ({"baseline.stats.blocks_shed": 1}, "accounting open"),
    ({"loaded.stats.blocks_ingested": 5}, "ingested by drain"),
])
def test_check_record_flags_each_gate(record, edits, match):
    """Synthetic records: timings set in the record, so no gate here reads
    this machine's clock."""
    clean = {"ingest_ratio": 1.0, "loaded.queries.point.p50_s": 0.001,
             "loaded.queries.point.p99_s": 0.001, "loaded.queries.top.p50_s": 0.001,
             "loaded.queries.top.p99_s": 0.001, "loaded.queries.kmaj.p50_s": 0.001,
             "loaded.queries.kmaj.p99_s": 0.001}
    rec = copy.deepcopy({k: v for k, v in record.items() if k != "_kept"})
    rec["impls"] = {"torch": rec["impls"]["torch"]}
    r = rec["impls"]["torch"]
    for path, value in {**clean, **edits}.items():
        node = r
        keys = path.split(".")
        for key in keys[:-1]:
            node = node[key]
        node[keys[-1]] = value
    failures = bench_serve.check_record(rec, min_ratio=0.9, p50_slo=0.5, p99_slo=5.0)
    assert len(failures) == 1 and match in failures[0], failures


def test_check_regression_compares_only_like_for_like(record):
    rec = {k: v for k, v in record.items() if k != "_kept"}
    emitted = []

    def emit(*a):
        emitted.append(a)

    assert bench_serve.check_regression(rec, None, emit=emit) == []
    assert emitted[-1][1] == "skipped" and "no committed" in emitted[-1][2]
    other = copy.deepcopy(rec)
    other["fingerprint"] = "cuda-nvidia-h100-80gb-hbm3-sm90-torch2.11"
    assert bench_serve.check_regression(rec, other, emit=emit) == []
    assert "fingerprint mismatch" in emitted[-1][2]
    shape = copy.deepcopy(rec)
    shape["config"]["k"] = 4096
    assert bench_serve.check_regression(rec, shape, emit=emit) == []
    assert "workload config drift (k)" in emitted[-1][2]
    faster = copy.deepcopy(rec)
    for r in faster["impls"].values():
        r["loaded"]["updates_per_s"] *= 4
    failures = bench_serve.check_regression(rec, faster, emit=emit)
    assert len(failures) == 2 and all("regressed" in f for f in failures)
    assert bench_serve.check_regression(rec, copy.deepcopy(rec), emit=emit) == []


def test_cli_writes_the_record_and_checks(tmp_path, capsys):
    out = tmp_path / "serve.json"
    argv = ["--device", "cpu", "--kernels", "torch", "--k", "64", "--lanes", "2",
            "--chunk", "128", "--depth", "2", "--blocks", "4", "--layers", "2",
            "--readers", "3", "--qps", "300", "--k-majority", "16",
            "--pipeline-blocks", "2", "--reference", "sorted", "--out", str(out)]
    assert bench_serve.main(argv) == 0
    rec = json.loads(out.read_text())
    assert rec["config"]["impls"] == ["torch"] and rec["summary"]["all_equivalent"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,value,derived"
    assert "serve_publish_every,8,plan=static" in lines
    assert "serve_regression_gate,skipped,no committed record" in lines
    # the second run compares against the first (same fingerprint and shape);
    # the timing gates are opened by their flags: this checks the plumbing
    argv += ["--check", "--min-ingest-ratio", "0", "--p50-slo", "1e9", "--p99-slo", "1e9",
             "--min-regression-frac", "0"]
    assert bench_serve.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("serve_torch_regression,") for ln in lines)
    assert lines[-1].startswith("check,ok")
