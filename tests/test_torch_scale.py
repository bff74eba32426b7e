"""The port's scaling sweep (``repro_torch.launch.scale``) on the CPU.

The CLI sweeps p ∈ {1, 2, 4} at its quick sizes: p = 1 in its own process,
p 2 and 4 each in a world of gloo ranks, in a subprocess with a timeout.
Every strong cell must be bitwise one SketchEngine over all p·lanes
tenants, and the record must have the JAX package's schema (held against
``repro.launch.scale.run_sweep`` at p 1, which needs no forced devices).
The gate's failure lines equal the JAX package's on the same hand-made
records, and the single-process reference equals the JAX package's.
No test here passes or fails on a timing.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.synthetic import zipf_stream
from repro.launch import scale as jscale
from repro_torch.launch import scale

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The record of ``scale --device cpu --quick --p 1,2,4 --check``."""
    root = tmp_path_factory.mktemp("scale")
    out = root / "scaling.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.scale", "--device", "cpu",
                        "--quick", "--p", "1,2,4", "--check", "--out", str(out)],
                       capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "check,ok" in r.stdout
    return json.loads(out.read_text())


def test_every_strong_cell_equals_the_single_process_engine(sweep):
    cells = sweep["cells"]
    assert {(c["mode"], c["strategy"], c["impl"], c["p"]) for c in cells} == {
        (m, s, i, p) for m in ("strong", "weak") for s in scale.STRATEGIES
        for i in ("torch", "sorted") for p in (1, 2, 4)}
    strong = [c for c in cells if c["mode"] == "strong"]
    assert all(c["equivalent"] is True for c in strong)
    assert sweep["summary"]["all_equivalent"] is True
    assert all("equivalent" not in c for c in cells if c["mode"] == "weak")
    for c in cells:
        assert c["pods"] == (2 if (c["strategy"], c["p"]) == ("hierarchical", 4) else 1)
        assert c["n"] == (1 << 16 if c["mode"] == "strong" else (1 << 14) * c["p"])
        assert c["total_s"] == pytest.approx(c["ingest_s"] + c["reduce_s"])
        assert c["efficiency"] > 0 and np.isfinite(c["efficiency"])
        if c["p"] == 1:
            assert c["speedup"] == c["efficiency"] == 1.0
    assert sweep["config"]["backend"] == "cpu" and sweep["config"]["devices"] == 4
    lat = sweep["reduction_latency_s"]
    assert set(lat) == {"torch", "sorted"}
    assert all(set(lat[i][s]) == {"1", "2", "4"} for i in lat for s in scale.STRATEGIES)


def test_record_schema_equals_jax(sweep):
    jrec = jscale.run_sweep(ps=[1], strategies=["butterfly"], impls=["sorted"], n=4096,
                            k=64, lanes=2, chunk=128, depth=2, repeat=1)
    assert set(sweep) == set(jrec)
    assert set(sweep["config"]) == set(jrec["config"])
    assert set(sweep["summary"]) == set(jrec["summary"])
    for mode in ("strong", "weak"):
        want = next(c for c in jrec["cells"] if c["mode"] == mode)
        got = next(c for c in sweep["cells"] if c["mode"] == mode)
        assert set(got) == set(want)


def test_single_process_reference_equals_jax():
    stream = zipf_stream(6_000, 1.2, seed=3, max_id=10**4)
    kw = dict(workers=4, k=64, chunk=128, depth=2, impl="sorted")
    got = scale._single_host_snapshot(torch.from_numpy(stream), device="cpu", **kw)
    want = jscale._single_host_snapshot(stream, **kw)
    for a, b in zip(got.summary, want.summary, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.n) == int(want.n)
    assert scale._snapshots_equal(got, got)
    assert all(scale._pods_for(s, p) == jscale._pods_for(s, p)
               for s in scale.STRATEGIES for p in range(1, 9))


def test_check_record_equals_jax():
    good = {"cells": [
        {"mode": "strong", "strategy": "butterfly", "impl": "sorted", "p": 1,
         "equivalent": True, "efficiency": 1.0},
        {"mode": "strong", "strategy": "butterfly", "impl": "sorted", "p": 2,
         "equivalent": True, "efficiency": 0.6},
        {"mode": "weak", "strategy": "allgather", "impl": "torch", "p": 4,
         "efficiency": 0.3}],
        "summary": {"all_equivalent": True}}
    assert scale.check_record(good) == jscale.check_record(good) == []
    bad = copy.deepcopy(good)
    bad["cells"][1]["equivalent"] = False
    bad["cells"][2]["efficiency"] = float("nan")
    bad["cells"][0]["efficiency"] = 0.0
    bad["summary"]["all_equivalent"] = False
    failures = scale.check_record(bad)
    assert failures == jscale.check_record(bad) and len(failures) == 4
    assert "strong/butterfly/sorted/p2: sharded snapshot != single-host engine" in failures
    assert "summary: not all strong-scaling cells equivalent" in failures
    del bad["cells"][2]["efficiency"]
    bad["summary"]["all_equivalent"] = None
    assert scale.check_record(bad) == jscale.check_record(bad)
