"""Paper-accuracy evaluation: sketch vs exact oracle over zipf streams.

The counterpart of ``repro.eval.accuracy``: for each (skew × k × impl)
cell, ingest a zipf stream through the full main path — SketchEngine
buffered updates → COMBINE tree → snapshot → QueryFrontend k-majority
report and point estimates — and score the report against the exact
counting oracle. Metrics per cell:

  precision / recall   of the candidate set vs the true k-majority set
  are                  average relative error of reported frequencies
  guaranteed_recall    fraction of *guaranteed* items that are truly
                       k-majority (f ≥ f̂ − ε makes this provably 1.0)
  guaranteed_coverage  fraction of the true k-majority set in the
                       guaranteed split
  bound_violations     point-estimate checks lower ≤ f ≤ f̂ over the true
                       heavy hitters (must be 0)

Each cell also records the host-clock time of its phases, measured after
a device synchronise: ``ingest_s`` (ingest with its flushes), ``query_s``
(snapshot + k-majority report, as the JAX harness times it) and
``estimate_s`` (the point-estimate batch of the bound audit).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.exact import exact_counts, score_reported, true_heavy_hitters
from repro_torch.core.spacesaving import EMPTY
from repro_torch.data.synthetic import zipf_stream
from repro_torch.engine import EngineConfig, SketchEngine
from repro_torch.service import QueryFrontend

SKEWS = (1.1, 1.5, 2.0)          # the paper's range (Table I spans 1.1–2.0)


def _clock(device) -> float:
    """Host time after the device has finished the work queued so far."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def exact_oracle(stream, k_majority: int):
    """The exact counts of ``stream`` and its true k-majority items."""
    return exact_counts(stream), true_heavy_hitters(stream, k_majority)


def run_cell(*, n: int, skew: float, k: int, impl: str,
             k_majority: int | None = None, seed: int = 0, tenants: int = 4,
             buffer_depth: int = 2, chunk: int = 2048, max_id: int = 10**6,
             fold: str = "mod", device: str = "cuda", stream=None, oracle=None):
    """One accuracy cell; returns ``(cell record, published snapshot)``.

    ``stream`` may hand in the zipf stream of these parameters, and
    ``oracle`` its ``exact_oracle(stream, k_majority)``, when the caller
    already made them (they are the costly part at large n).
    """
    k_maj = k_majority if k_majority else k
    if stream is None:
        stream = zipf_stream(n, skew, seed=seed, max_id=max_id, fold=fold)

    # the paper's block decomposition: split the stream over the tenants
    per = -(-n // tenants)
    padded = np.full(per * tenants, EMPTY, np.int32)
    padded[:n] = stream
    engine = SketchEngine(EngineConfig(
        k=k, tenants=tenants, chunk=min(chunk, per), kernel=impl,
        buffer_depth=buffer_depth, device=device))
    blocks = torch.from_numpy(padded.reshape(tenants, per)).to(device)

    t0 = _clock(device)
    state = engine.ingest(engine.init(), blocks)
    t1 = _clock(device)
    snap = engine.snapshot(state)
    frontend = QueryFrontend(impl)
    report = frontend.k_majority_report(snap, k_maj)
    t2 = _clock(device)

    if int(snap.n) != n:
        raise AssertionError(f"snapshot n {int(snap.n)} != stream n {n}")
    exact, truth = oracle if oracle is not None else exact_oracle(stream, k_maj)
    cell = {"skew": skew, "k": k, "impl": impl, "k_majority": k_maj, "n": n,
            **score_snapshot(snap, frontend, report, exact, truth, device),
            "device": str(device), "tenants": tenants,
            "ingest_s": t1 - t0, "query_s": t2 - t1}
    return cell, snap


def score_snapshot(snap, frontend, report, exact: dict, truth: dict, device) -> dict:
    """A snapshot's k-majority ``report`` scored against the exact oracle.

    The report's precision, recall and ARE, its guaranteed split, and the
    point-estimate bound audit (``frontend.estimate`` over the true heavy
    hitters, timed as ``estimate_s``).
    """
    reported = {int(i): int(c) for i, c in zip(report.candidate_items,
                                               report.candidate_counts)}
    guaranteed = [int(i) for i in report.guaranteed_items]
    gset = set(guaranteed)
    metrics = score_reported(reported, truth, exact)
    g_true = [g for g in guaranteed if exact.get(g, 0) >= report.threshold]
    guaranteed_recall = len(g_true) / len(guaranteed) if guaranteed else 1.0
    guaranteed_coverage = (len([t for t in truth if t in gset]) / len(truth)
                           if truth else 1.0)

    # point-estimate bound audit over the true heavy hitters
    bound_violations = 0
    estimate_s = 0.0
    if truth:
        q = np.fromiter(truth.keys(), np.int32)
        t3 = _clock(device)
        f_hat, lower, _ = frontend.estimate(snap, q)
        f_hat, lower = f_hat.cpu().numpy(), lower.cpu().numpy()
        estimate_s = time.perf_counter() - t3
        for i, item in enumerate(q):
            if not (lower[i] <= exact[int(item)] <= f_hat[i]):
                bound_violations += 1
    return {
        "threshold": report.threshold, "complete": report.complete,
        "snapshot_version": snap.version, "n_true": metrics.n_true,
        "n_reported": metrics.n_reported,
        "n_guaranteed": len(guaranteed), "precision": metrics.precision,
        "recall": metrics.recall, "are": metrics.are,
        "guaranteed_recall": guaranteed_recall,
        "guaranteed_coverage": guaranteed_coverage,
        "bound_violations": bound_violations, "estimate_s": estimate_s,
    }


def evaluate_cell(**kwargs) -> dict:
    """One accuracy cell through the main path (arguments of :func:`run_cell`).

    ``k_majority`` defaults to ``k`` — the paper's tight setting.
    """
    return run_cell(**kwargs)[0]


def run_sweep(*, n: int = 200_000, skews=SKEWS, ks=(256, 1024),
              impls=("torch", "sorted"), k_majority: int | None = None,
              seed: int = 0, tenants: int = 4, max_id: int = 10**6,
              fold: str = "mod", device: str = "cuda", emit=None) -> dict:
    """The full (skew × k × impl) accuracy matrix → one record."""
    cells = []
    for skew in skews:
        stream = zipf_stream(n, skew, seed=seed, max_id=max_id, fold=fold)
        for k in ks:
            oracle = exact_oracle(stream, k_majority or k)
            for impl in impls:
                cell = evaluate_cell(n=n, skew=skew, k=k, impl=impl,
                                     k_majority=k_majority, seed=seed,
                                     tenants=tenants, max_id=max_id, fold=fold,
                                     device=device, stream=stream, oracle=oracle)
                cells.append(cell)
                if emit is not None:
                    emit(f"acc_z{skew}_k{k}_{impl}", cell["are"],
                         f"precision={cell['precision']:.4f};"
                         f"recall={cell['recall']:.4f};"
                         f"guaranteed_recall={cell['guaranteed_recall']:.4f};"
                         f"guaranteed_coverage={cell['guaranteed_coverage']:.4f}")
    return {
        "meta": {"n": n, "tenants": tenants, "seed": seed, "max_id": max_id,
                 "fold": fold, "skews": list(skews), "ks": list(ks),
                 "impls": list(impls), "device": str(device),
                 "generated_by": "python -m repro_torch.launch.eval"},
        "cells": cells,
        "summary": {
            "min_guaranteed_recall": min(c["guaranteed_recall"] for c in cells),
            "min_recall": min(c["recall"] for c in cells),
            "min_precision": min(c["precision"] for c in cells),
            "max_are": max(c["are"] for c in cells),
            "total_bound_violations": sum(c["bound_violations"] for c in cells),
        },
    }


def oracle_free_invariants(snap, report) -> dict:
    """The invariants a live tier can verify WITHOUT the exact oracle.

    Computed from a published snapshot + its QueryFrontend k-majority
    report with plain integer arithmetic — the reference the obs layer's
    health gauges (``repro_torch.obs.health.sketch_health``) must match
    bitwise (the serving tier's health gate in ``launch/bench_serve.py``).
    """
    n, k = int(snap.n), int(snap.k)
    occupancy = int(snap.occupancy)
    min_count = int(snap.min_count)      # min_frequency: 0 unless full
    n_cand = len(report.candidate_items)
    n_guar = len(report.guaranteed_items)
    return {
        "n": n,
        "k": k,
        "occupancy": occupancy,
        "min_count": min_count,
        "threshold": int(report.threshold),
        "complete": bool(report.complete),
        "candidates": n_cand,
        "guaranteed": n_guar,
        "unconfirmed": n_cand - n_guar,
        "guaranteed_fraction": (n_guar / n_cand) if n_cand else 1.0,
    }


def check_record(record: dict) -> list[str]:
    """The paper's correctness invariants as gates. Empty list = pass.

    * guaranteed_recall == 1.0 — a guaranteed item that is not truly
      k-majority would falsify f ≥ f̂ − ε;
    * recall == 1.0 for ``complete`` cells — containment;
    * zero point-estimate bound violations.
    """
    failures = []
    for c in record["cells"]:
        tag = f"z{c['skew']}/k{c['k']}/{c['impl']}"
        if c["guaranteed_recall"] < 1.0:
            failures.append(f"{tag}: guaranteed_recall="
                            f"{c['guaranteed_recall']:.4f} < 1.0")
        if c["recall"] < 1.0 and c.get("complete", True):
            failures.append(f"{tag}: recall={c['recall']:.4f} < 1.0 "
                            "(containment violated)")
        if c["bound_violations"]:
            failures.append(f"{tag}: {c['bound_violations']} point-estimate "
                            "bound violations")
    return failures
