"""The port's main path as a whole against repro's accuracy harness.

``evaluate_cell`` runs zipf stream → tenant split → SketchEngine ingest →
COMBINE tree → snapshot → k-majority report + point-estimate audit. On the
CPU, at n ≈ 20 000 and k = 64, every metric of the port's cell equals the
JAX cell, and the published snapshot is bitwise the JAX engine's.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import zipf_stream
from repro.engine import EngineConfig as JConfig
from repro.engine import SketchEngine as JEngine
from repro.eval.accuracy import evaluate_cell as j_evaluate_cell
from repro.service import QueryFrontend as JFrontend
from repro_torch.eval import accuracy as tacc
from repro_torch.launch import eval as teval

# one intra-op thread per test process: the suite runs in parallel
# workers, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

METRICS = ("skew", "k", "k_majority", "n", "threshold", "complete", "n_true",
           "n_reported", "n_guaranteed", "precision", "recall", "are",
           "guaranteed_recall", "guaranteed_coverage", "bound_violations")
N = 20_000


@pytest.mark.parametrize("skew", [1.1, 2.0])
def test_evaluate_cell_equals_jax_cell(skew):
    jcell = j_evaluate_cell(n=N, skew=skew, k=64, impl="jnp")
    for impl in ("torch", "sorted"):
        cell = tacc.evaluate_cell(n=N, skew=skew, k=64, impl=impl, device="cpu")
        assert {m: cell[m] for m in METRICS} == {m: jcell[m] for m in METRICS}
        assert cell["impl"] == impl and cell["device"] == "cpu"
        assert cell["ingest_s"] >= 0 and cell["query_s"] >= 0


@pytest.mark.parametrize("skew", [1.1, 2.0])
def test_main_path_snapshot_bitwise(skew):
    """evaluate_cell's path, snapshot and report, against the JAX engine.

    Four tenants of 5 000 ids each through k = 64 counters: summaries
    overflow, so errors and evictions are exercised.
    """
    stream = zipf_stream(N, skew, seed=0, max_id=10**6)
    cell, snap = tacc.run_cell(n=N, skew=skew, k=64, impl="torch", device="cpu",
                               stream=stream)
    je = JEngine(JConfig(k=64, tenants=4, chunk=2048, kernel="jnp", buffer_depth=2))
    jsnap = je.snapshot(je.ingest(je.init(), stream.reshape(4, -1)))
    for a, b in zip(jsnap.summary, snap.summary):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jsnap.n) == int(snap.n) == N
    np.testing.assert_array_equal(np.asarray(jsnap.shard_n), snap.shard_n.numpy())
    assert int(np.asarray(jax.device_get(jsnap.summary.errors)).max()) > 0
    jr = JFrontend("jnp").k_majority_report(jsnap, 64)
    assert cell["n_guaranteed"] == len(jr.guaranteed_items)
    assert cell["threshold"] == jr.threshold


def test_check_record_gates():
    good = {"skew": 1.1, "k": 64, "impl": "torch", "guaranteed_recall": 1.0,
            "recall": 1.0, "complete": True, "bound_violations": 0}
    assert tacc.check_record({"cells": [good]}) == []
    bad = [{**good, "guaranteed_recall": 0.5}, {**good, "recall": 0.9},
           {**good, "recall": 0.9, "complete": False}, {**good, "bound_violations": 2}]
    failures = tacc.check_record({"cells": bad})
    assert len(failures) == 3
    assert "guaranteed_recall" in failures[0] and "containment" in failures[1]


def test_eval_cli_check_writes_record(tmp_path, capsys):
    out = tmp_path / "acc.json"
    rc = teval.main(["--device", "cpu", "--n", "8000", "--k", "64", "--skews", "1.1,2.0",
                     "--kernels", "torch,sorted", "--check", "--out", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert len(record["cells"]) == 4
    assert record["summary"]["min_guaranteed_recall"] == 1.0
    assert record["summary"]["total_bound_violations"] == 0
    assert record["meta"]["device"] == "cpu"
    assert "check,ok" in capsys.readouterr().out
    # without --out nothing is written; on the CPU the default impls are torch,sorted
    assert teval.main(["--device", "cpu", "--n", "2000", "--k", "64", "--skews", "1.5"]) == 0
    assert "acc_z1.5_k64_torch" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["acc.json"]
