"""The port's obs launchers (``launch/bench_obs.py``, ``launch/metrics.py``) on the CPU.

``compare_health`` and ``check_record`` are held against the JAX
package's on the same dicts. A short ``run_bench`` on the CPU must pass
every gate but the overhead ratio (a timing, not asserted here): the
health gauges equal ``oracle_free_invariants``, every drift CI covers its
skew, and the induced-error flight record is valid. The metrics CLI prints
JSON, Prometheus text whose every line parses, and trace events; its tier
registry holds the same instrument names as the JAX package's after the
same small run.
"""
import copy
import json
import re

import pytest
import torch

from repro.launch import bench_obs as jbench_obs
from repro.launch import metrics as jmetrics
from repro_torch.eval.accuracy import SKEWS
from repro_torch.launch import bench_obs, metrics
from repro_torch.obs import metrics as obs_metrics
from repro_torch.plan import clear

torch.set_num_threads(1)

#: a Prometheus text exposition line: a comment, or a sample with a value
PROM_LINE = re.compile(
    r"^(# (TYPE|HELP) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (-?[0-9.]+([eE][-+]?[0-9]+)?|NaN|[-+]Inf))$")
SMALL = ["--blocks", "2", "--layers", "1", "--k", "64", "--chunk", "128"]
PROCESS_COUNTERS = ("engine.flush_calls", "runtime.snapshot_publishes")


def _process_values():
    """The process registry's counters, 0 where the process has not created
    them yet. ``DEFAULT`` holds the counts of every earlier test in the same
    worker, so a test reads it before its own calls and compares deltas
    (the idiom of ``tests/test_torch_obs.py:_values``)."""
    d = obs_metrics.DEFAULT.describe()
    return {n: d[n]["value"] if n in d else 0 for n in PROCESS_COUNTERS}


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    monkeypatch.chdir(tmp_path)          # a tier's default flight_path is the cwd
    clear()
    yield
    clear()


def test_compare_health_equals_jax():
    assert bench_obs.HEALTH_FIELDS == jbench_obs.HEALTH_FIELDS
    ref = {f: i for i, f in enumerate(bench_obs.HEALTH_FIELDS)}
    assert bench_obs.compare_health(dict(ref), ref) == []
    for got in ({**ref, "n": 99, "complete": True}, {"k": 1}, {}):
        lines = bench_obs.compare_health(got, ref)
        assert lines == jbench_obs.compare_health(got, ref) and lines


def test_check_record_equals_jax():
    record = {
        "overhead": {"ratio": 0.99},
        "health": {"tier": {"n": 1}, "reference": {"n": 1}, "mismatches": []},
        "drift": [{"s_true": 1.5, "s_est": 1.49, "ci_low": 1.45,
                   "ci_high": 1.55, "within_ci": True}],
        "flight": {"valid": True, "reason": "ingest_error"},
    }
    cases = [copy.deepcopy(record)]
    record["overhead"]["ratio"] = 0.9
    record["health"]["mismatches"] = ["n: health gauge 1 != invariant 2"]
    record["drift"][0]["within_ci"] = False
    record["flight"] = {"valid": False, "reason": "no dump appeared"}
    cases.append(copy.deepcopy(record))
    del record["drift"], record["flight"]
    record["health"]["tier"] = {}
    record["overhead"]["ratio"] = float("nan")
    cases.append(record)
    for case in cases:
        for min_ratio in (0.97, 0.0):
            assert bench_obs.check_record(case, min_ratio=min_ratio) == \
                jbench_obs.check_record(case, min_ratio=min_ratio)
    assert bench_obs.check_record(cases[0], min_ratio=0.97) == []
    assert len(bench_obs.check_record(cases[1], min_ratio=0.97)) == 4
    assert len(bench_obs.check_record(cases[2], min_ratio=0.97)) == 5


def test_run_bench_gates_on_cpu(tmp_path):
    lines = []
    record = bench_obs.run_bench(
        impl="torch", k=256, lanes=2, chunk=512, depth=2, blocks=16, layers=8,
        publish_every=2, ring_depth=4, reps=1, device="cpu",
        flight_path=str(tmp_path / "flight.json"), emit=lambda *a: lines.append(a))
    assert bench_obs.check_record(record, min_ratio=0.0) == []
    assert record["health"]["mismatches"] == [] and record["health"]["tier"]["n"] > 0
    assert [r["s_true"] for r in record["drift"]] == list(SKEWS)
    assert all(r["ci_low"] <= r["s_true"] <= r["ci_high"] for r in record["drift"])
    flight = record["flight"]
    assert flight["valid"] and flight["error_type"] == "RuntimeError"
    assert flight["reason"] == "ingest_error" and flight["frames"] >= 1
    assert json.loads((tmp_path / "flight.json").read_text())["reason"] == "ingest_error"
    assert len(record["overhead"]["off_updates_per_s"]) == 1
    assert record["overhead"]["ratio"] > 0
    assert record["metrics_on_stats"]["blocks_ingested"] == 16
    assert record["config"]["backend"] == "cpu"
    assert {name for name, *_ in lines} >= {"obs_overhead_ratio", "obs_health_consistent",
                                            "obs_flight_valid"}
    assert not list(tmp_path.glob("flight_record*.json"))   # the arms' dumps are temporary


def test_metrics_cli_json(capsys):
    before = _process_values()
    assert metrics.main(["--device", "cpu", *SMALL]) == 0
    dump = json.loads(capsys.readouterr().out)
    assert "tier" in dump and "process" in dump
    assert "serve.read.top_s" in dump["tier"]["metrics"]
    assert dump["tier"]["health"]["n"] > 0
    assert dump["tier"]["blocks_ingested"] == 2
    assert dump["process"]["runtime.snapshot_publishes"]["value"] \
        - before["runtime.snapshot_publishes"] > 0
    assert dump["process"]["engine.flush_calls"]["value"] == before["engine.flush_calls"]


def test_metrics_cli_prometheus_and_events(capsys):
    before = _process_values()
    assert metrics.main(["--device", "cpu", *SMALL, "--format", "prom", "--events", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    tail = [ln for ln in out if ln.startswith('{"kind"')]
    prom = [ln for ln in out if not ln.startswith('{"kind"')]
    assert "# TYPE serve_read_top_s histogram" in prom
    assert 1 <= len(tail) <= 4 and all("name" in json.loads(ln) for ln in tail)
    bad = [ln for ln in prom if not PROM_LINE.match(ln)]
    assert not bad, bad[:5]
    # the tier's registry is printed first, then the process registry, where
    # an earlier test in the same worker may have counted serve.ingest.*
    # through a loop on DEFAULT: a name's first sample is the tier's
    samples = {}
    for ln in prom:
        if not ln.startswith("#"):
            samples.setdefault(*ln.rsplit(" ", 1))
    assert float(samples["serve_ingest_blocks"]) == 2
    assert float(samples["runtime_snapshot_publishes"]) \
        - before["runtime.snapshot_publishes"] > 0
    # auto-flushes are not counted: the run adds no flush call
    assert float(samples["engine_flush_calls"]) - before["engine.flush_calls"] == 0


def test_metrics_instrument_names_equal_jax():
    kw = dict(k=64, lanes=2, chunk=128, depth=2, blocks=2, layers=1, publish_every=2,
              ring_depth=4, kmaj=64, seed=0)
    _, registry, _ = metrics.run_tier_dump(device="cpu", **kw)
    _, jregistry, _ = jmetrics.run_tier_dump(**kw)
    assert set(registry.names()) == set(jregistry.names())


def test_metrics_watch_prints_status_lines():
    printed = []
    desc = metrics.run_watch(k=64, lanes=2, chunk=128, depth=2, layers=1, duration=0.6,
                             refresh_s=0.2, events=True, device="cpu",
                             _printer=printed.append)
    status = [ln for ln in printed if ln.startswith("[watch]")]
    assert len(status) >= 2 and "blk_per_s" in status[-1] and "n=" in status[-1]
    assert desc["blocks_ingested"] > 0
