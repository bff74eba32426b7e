"""The port's tune CLI (``repro_torch.launch.tune``) on the CPU.

No test here passes or fails on a timing. The CLI runs end to end at a
tiny grid with a deterministic stand-in for the kernel probes' timer
(every probed call still runs once), which makes its plan, its tolerance
gate and its cache write a function of the synthetic times; the bitwise
gate, the probe coverage, the cache write and the pick-up of the plan by
every ``'auto'`` are then checked. One run with the real timer checks
everything but the timing verdict. The choosers are held against the JAX
package's on synthetic rows, and the tolerance decision is tested on
synthetic times. What the CLI refuses (the ``cuda`` impl off a CUDA
device, unknown ops) raises before any probe; on the card its default grid
is JAX's.

The serving probes (publish, pipeline) run with the real timer: the plan's
knobs must be the choosers applied to the recorded rows, and every probe
leaves its warmed state as it was (the engine writes a buffer in place).
The reduction probes run over spawned gloo ranks at p 2 and 4, in a
subprocess with a timeout.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import tune as jtune
from repro.plan import probe as jprobe
from repro.plan.model import CostModel as JCostModel
from repro_torch.engine import EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch import tune
from repro_torch.plan import (CostModel, ExecutionPlan, active_plan, clear,
                              device_fingerprint, plan_path)
from repro_torch.plan import probe
from repro_torch.runtime import RuntimeConfig
from repro_torch.serve import ServeConfig
from repro_torch.service import QueryFrontend

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

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
    """``probe.timeit`` of a kernel cell → one real call, then the synthetic
    time of the cell; the runtime probes keep the real timer."""
    real = probe.timeit

    def fake(fn, *args, **kw):
        if not isinstance(fn, functools.partial):
            return real(fn, *args, **kw)
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


def _no_card_fingerprint(monkeypatch):
    """A card's fingerprint without a card: the CLI names its device before
    it probes."""
    import repro_torch.plan as tplan
    real = tplan.device_fingerprint
    monkeypatch.setattr(tplan, "device_fingerprint",
                        lambda device=None: "cuda-h100-test" if str(device).startswith("cuda")
                        else real(device))


def test_refusals_before_any_probe(tmp_path, monkeypatch):
    def no_probe(*a, **k):
        raise AssertionError("probed")
    monkeypatch.setattr(probe, "probe_kernels", no_probe)
    _no_card_fingerprint(monkeypatch)
    base = ["--cache-dir", str(tmp_path), "--out", str(tmp_path / "r.json")]
    with pytest.raises(ValueError, match="needs --device cuda"):
        tune.main(["--device", "cpu", "--no-reductions", "--kernels", "cuda", *base])
    # the fused kernels take every k and window: large grids reach the probes
    with pytest.raises(AssertionError, match="probed"):
        tune.main(["--device", "cuda", "--no-reductions", "--k", "256,4096", *base])
    with pytest.raises(AssertionError, match="probed"):
        tune.main(["--device", "cuda", "--no-reductions", "--chunks", "512,32768", *base])
    tune._check_surface(("update", "flush"), ("cuda",), "cuda")
    with pytest.raises(ValueError, match="not in"):
        tune.main(["--device", "cpu", "--no-reductions", "--ops", "merge", *base])
    assert not (tmp_path / "r.json").exists()


def _default_grid(main, probe_module, monkeypatch, argv):
    """The (ks, cs) of the first kernel probe that ``main(argv)`` asks for."""
    class Probed(Exception):
        pass

    def first(*a, ks, cs, **kw):
        raise Probed(list(ks), list(cs))
    monkeypatch.setattr(probe_module, "probe_kernels", first)
    with pytest.raises(Probed) as got:
        main(argv)
    return got.value.args


def test_card_default_grid_equals_jax(tmp_path, monkeypatch):
    """On the card the default k and chunk grids are JAX's (256,1024,4096 and
    512,2048,8192): the fused kernels take every shape they probe."""
    _no_card_fingerprint(monkeypatch)
    base = ["--no-reductions", "--cache-dir", str(tmp_path), "--out", str(tmp_path / "r.json")]
    card = _default_grid(tune.main, probe, monkeypatch, ["--device", "cuda", *base])
    cpu = _default_grid(tune.main, probe, monkeypatch, ["--device", "cpu", *base])
    jax_ = _default_grid(jtune.main, jprobe, monkeypatch, base)
    assert card == cpu == jax_ == ([256, 1024, 4096], [512, 2048, 8192])


def test_serving_choosers_equal_jax():
    assert (tune.PUBLISH_BUDGET, tune.PIPELINE_SLACK, tune.LAZY_PUBLISH_MIN_RATIO) == \
        (jtune.PUBLISH_BUDGET, jtune.PIPELINE_SLACK, jtune.LAZY_PUBLISH_MIN_RATIO)
    assert tune.DEFAULT_OPS == jtune.DEFAULT_OPS and tune.STRATEGIES == jtune.STRATEGIES
    publish = [[], [{"k": 256, "publish_per_step": 0.05}, {"k": 2048, "publish_per_step": 0.35}],
               [{"k": 64, "publish_per_step": 0.0}], [{"k": 64, "publish_per_step": 1e5}],
               [{"k": 64, "publish_per_step": 3000.0}], [{"k": 64, "publish_per_step": 25.6}]]
    for rows in publish:
        for budget in (0.1, 0.5):
            assert tune._choose_publish(rows, budget) == jtune._choose_publish(rows, budget)
    assert tune._choose_publish([]) == (8, 4)
    assert tune._choose_publish(publish[2]) == (1, 2)            # the lower clamps
    assert tune._choose_publish(publish[3]) == (256, 16)         # the upper clamps
    assert tune._choose_publish(publish[5]) == (256, 3)          # a tie at the 256 edge
    co = [{"op": "pipeline", "knob": "coalesce", "m": m, "block_s": t}
          for m, t in ((1, 1.0), (2, 0.62), (4, 0.60), (8, 0.612))]
    fe = [{"op": "pipeline", "knob": "feed", "depth": d, "block_s": t}
          for d, t in ((1, 1.0), (2, 0.8), (4, 0.79))]
    for eager in (0.2, 0.05, 0.01):
        rows = co + fe + [{"op": "pipeline", "knob": "publish", "step_s": 1.0,
                           "eager_s": eager}]
        for cut in (rows, co, fe, rows[-1:], []):
            assert tune._choose_pipeline(cut) == jtune._choose_pipeline(cut)
    assert tune._choose_pipeline([]) == (1, 2, False)
    assert tune._choose_pipeline(co + fe)[:2] == (4, 2)          # 8 ties 4 within 2%: 4
    tie = [{"op": "pipeline", "knob": "coalesce", "m": 1, "block_s": 1.02},
           {"op": "pipeline", "knob": "coalesce", "m": 2, "block_s": 1.0}]
    assert tune._choose_pipeline(tie)[0] == jtune._choose_pipeline(tie)[0] == 1


def test_serving_probes_keep_the_warmed_state(monkeypatch):
    """Every timed ingest starts from a copy: the warmed states end bitwise
    as they began, and the rows have the JAX package's keys and cells."""
    kept = []
    real = probe._warmed

    def spy(rt, stream):
        st = real(rt, stream)
        kept.append((st, st.fill, [t.clone() for t in (*st.summary, st.buffer, st.n)]))
        return st

    monkeypatch.setattr(probe, "_warmed", spy)
    geometry = dict(lanes=2, chunk=256, depth=4, repeat=1)
    pub = probe.probe_publish(ks=(64,), impl="sorted", device="cpu", **geometry)
    pipe = probe.probe_pipeline(k=64, coalesce=(1, 2), feed_depths=(1, 2), impl="sorted",
                                device="cpu", **geometry)
    assert len(kept) == 4                 # publish, pipeline, one feed runtime a depth
    for st, fill, before in kept:
        assert st.fill == fill == 0
        for a, b in zip((*st.summary, st.buffer, st.n), before, strict=True):
            assert torch.equal(a, b)
    jpub = jprobe.probe_publish(ks=(64,), impl="jnp", **geometry)
    jpipe = jprobe.probe_pipeline(k=64, coalesce=(1, 2), feed_depths=(1, 2), impl="jnp",
                                  **geometry)
    timed = {"step_s", "publish_s", "publish_per_step", "block_s", "eager_s"}

    def cells(rows):
        return [{key: v for key, v in r.items() if key not in timed} for r in rows]

    assert [set(r) for r in pub] == [set(r) for r in jpub]
    assert [set(r) for r in pipe] == [set(r) for r in jpipe]
    assert cells(pub) == cells(jpub) and cells(pipe) == cells(jpipe)
    assert all(r[key] > 0 for r in pub + pipe for key in timed & set(r))


def test_cli_serving_knobs_follow_the_choosers(tmp_path, synthetic_timer):
    """The plan's knobs are the choosers on the record's own rows, and every
    None knob of the tier and the runtime resolves through the plan."""
    out = tmp_path / "r.json"
    rc = tune.main(["--device", "cpu", "--quick", "--ops", "combine,publish,pipeline",
                    "--kernels", "torch,sorted", "--p", "1", "--cache-dir",
                    str(tmp_path / "plans"), "--out", str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    plan = ExecutionPlan.from_json(record["plan"])
    assert record["config"]["ops"] == ["combine", "publish", "pipeline"]
    assert {r["op"] for r in record["probes"]} == {"combine"}
    assert [r["k"] for r in record["publish_probes"]] == [64, 1024]
    assert {r["knob"] for r in record["pipeline_probes"]} == {"coalesce", "feed", "publish"}
    assert (plan.publish_every, plan.ring_depth) == \
        tune._choose_publish(record["publish_probes"])
    assert (plan.coalesce_max, plan.feed_depth, plan.lazy_publish) == \
        tune._choose_pipeline(record["pipeline_probes"])
    # p = 1 only: every strategy is probed, and no table is written
    assert sorted(r["strategy"] for r in record["reduction_probes"]) == \
        sorted(tune.STRATEGIES)
    assert {r["p"] for r in record["reduction_probes"]} == {1}
    assert plan.reductions == {} and plan.pods == {}
    clear()
    assert active_plan("cpu") == plan
    cfg = ServeConfig(runtime=RuntimeConfig(engine=EngineConfig(k=64, device="cpu"),
                                            pods=None, reduction="auto"))
    assert cfg.resolved_publish_every() == plan.publish_every
    assert cfg.resolved_ring_depth() == plan.ring_depth
    assert cfg.resolved_coalesce_max() == plan.coalesce_max
    assert cfg.resolved_lazy_publish() == plan.lazy_publish
    assert cfg.runtime.resolved_feed_depth() == plan.feed_depth
    assert cfg.runtime.resolved_reduction(1) == "local"
    assert (cfg.runtime.resolved_reduction(4), cfg.runtime.resolved_pods(4)) == \
        ("butterfly", 1)


def test_agreed_count_without_a_group():
    assert probe.agreed_count(7) == 7


RANKS = r'''
import json
import sys

import torch
import torch.distributed as dist

from repro_torch.launch import tune
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.plan import probe


def agree(values):
    """Each rank: rank 0's value, and the calls a timed collective made."""
    got = probe.agreed_count(values[dist.get_rank()])
    calls, t = [0], torch.zeros(1)

    def collective():
        calls[0] += 1
        dist.all_reduce(t)

    probe.timeit(collective, repeat=3, device="cpu")
    out = [torch.zeros(2, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(out, torch.tensor([got, calls[0]]))
    return [o.tolist() for o in out]


if __name__ == "__main__":
    root = sys.argv[1]
    with open(f"{root}/agree.json", "w") as f:
        json.dump(spawn_ranks(3, agree, [5, 9, 11]), f)
    sys.exit(tune.main(["--device", "cpu", "--ops", "combine", "--kernels", "torch,sorted",
                        "--k", "64,128", "--chunks", "128,256", "--repeat", "1",
                        "--p", "1,2,4", "--n-reduce", "8192", "--cache-dir",
                        f"{root}/plans", "--out", f"{root}/r.json"]))
'''


def test_reduction_probes_over_gloo_ranks(tmp_path):
    """p 2 and 4 each in a world of their own: the table is JAX's argmin per
    p > 1, hierarchical runs on 2 pods at p 4, and the ranks agree."""
    script = tmp_path / "ranks.py"
    script.write_text(RANKS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    agreed = json.loads((tmp_path / "agree.json").read_text())
    assert [got for got, _ in agreed] == [5, 5, 5]
    assert len({calls for _, calls in agreed}) == 1
    record = json.loads((tmp_path / "r.json").read_text())
    rows = record["reduction_probes"]
    assert {(r["strategy"], r["p"]) for r in rows} == \
        {(s, p) for s in tune.STRATEGIES for p in (1, 2, 4)}
    assert all(r["time_s"] > 0 and r["k"] == 128 for r in rows)
    assert {(r["strategy"], r["p"]): r["pods"] for r in rows}[("hierarchical", 4)] == 2
    assert all(r["pods"] == 1 for r in rows if (r["strategy"], r["p"]) != ("hierarchical", 4))
    want = {p: min((r for r in rows if r["p"] == p),
                   key=lambda r: (r["time_s"], r["strategy"])) for p in (2, 4)}
    assert record["plan"]["reductions"] == {str(p): w["strategy"] for p, w in want.items()}
    assert record["plan"]["pods"] == {str(p): w["pods"] for p, w in want.items()}
    assert tune._choose_reductions(rows) == ({p: w["strategy"] for p, w in want.items()},
                                             {p: w["pods"] for p, w in want.items()})
