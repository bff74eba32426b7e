"""The LM serving path of the port against the JAX package's, on the CPU.

  * ``train/sketch.py``: ``update_token_sketch``, ``update_expert_sketch``
    and ``merge_sketches`` give ``repro.train.sketch``'s bits at G 1 and
    G 4 (the whole state after every step: summaries, buffer, fill, n;
    tolerance 0, integer sums), under the JAX impl names ``sorted`` and
    ``jnp`` (``jnp`` runs the port's ``torch``), and ``state_shapes``
    gives JAX's shapes and dtypes;
  * ``train/steps.py``: prefill and 16 serve steps against JAX's
    ``make_prefill_step``/``make_serve_step`` on the JAX package's weights
    (``models/convert.py``) at the smoke size, f32: prefill logits within
    2e-5 (the same f32 operations, only the summation order inside each
    product differs between XLA and ATen), greedy tokens equal step by
    step, the token sketch bitwise equal after every step;
  * ``launch/serve.py``: ``run_serve``'s sketch is bitwise a ``sorted``
    engine fed the emitted tokens in the same chunks, and holds the
    guarantees against exact counts; ``main`` prints its trace lines and a
    parsable ``--metrics-dump``; it imports no JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_arch as jax_smoke_arch
from repro.models import model as JM
from repro.sharding.rules import ShardingPlan as JShardingPlan
from repro.train import sketch as JSK
from repro.train import steps as JS
from repro_torch.configs.registry import get_smoke_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import state_to_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models import model as M
from repro_torch.obs import metrics as obs_metrics
from repro_torch.plan import clear
from repro_torch.sharding.rules import ShardingPlan
from repro_torch.train import sketch as SK
from repro_torch.train import steps as S

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _empty_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    monkeypatch.delenv("REPRO_TORCH_PLAN_FILE", raising=False)
    clear()
    yield
    clear()


def _cfgs(kernel, name="qwen2.5-14b"):
    """The port's and JAX's smoke configs with the sketch pinned to ``kernel``
    (a JAX impl name: the port maps it)."""
    def pin(c):
        return dataclasses.replace(c, sketch=dataclasses.replace(c.sketch, kernel=kernel))
    return pin(get_smoke_arch(name)), pin(jax_smoke_arch(name))


def _assert_state(jstate, state):
    for a, b in zip((np.asarray(x) for x in jax.tree.leaves(jstate)), state_to_numpy(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _assert_summary(js, s):
    for a, b in zip(js, s):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("kernel", ["sorted", "jnp"])
@pytest.mark.parametrize("groups", [1, 4])
def test_token_sketch_updates_equal_jax(kernel, groups):
    cfg, jcfg = _cfgs(kernel)
    engine = SK.token_engine(cfg.sketch, groups, device="cpu")
    jengine = JSK.token_engine(jcfg.sketch, groups)
    assert engine.config.kernel == {"jnp": "torch"}.get(kernel, kernel)
    state = SK.init_token_sketch(cfg.sketch, groups, device="cpu")
    jstate = JSK.init_token_sketch(jcfg.sketch, groups)
    data = TokenStream(cfg.vocab, 4, 64)
    for _ in range(9):          # two flushes and a partly filled buffer
        tokens = data.next()["tokens"]
        state = SK.update_token_sketch(engine, state, torch.from_numpy(tokens))
        jstate = JSK.update_token_sketch(jengine, jstate, jnp.asarray(tokens))
        _assert_state(jstate, state)
    _assert_summary(JSK.merge_sketches(jengine, jstate), SK.merge_sketches(engine, state))
    _assert_summary(JS.make_merge_step(jcfg)(jstate),
                    S.make_merge_step(cfg, device="cpu")(state))


@pytest.mark.parametrize("kernel", ["sorted", "jnp"])
def test_expert_sketch_updates_equal_jax(kernel, rng):
    cfg, jcfg = _cfgs(kernel, "mixtral-8x7b")
    engine = SK.expert_engine(cfg.sketch, device="cpu")
    jengine = JSK.expert_engine(jcfg.sketch)
    state = SK.init_expert_sketch(cfg.sketch, device="cpu")
    jstate = JSK.init_expert_sketch(jcfg.sketch)
    for _ in range(5):
        counts = rng.integers(0, 50, (cfg.moe.n_experts,)).astype(np.int32)
        counts[rng.integers(0, cfg.moe.n_experts)] = 0
        state = SK.update_expert_sketch(engine, state, torch.from_numpy(counts))
        jstate = JSK.update_expert_sketch(jengine, jstate, jnp.asarray(counts))
        _assert_state(jstate, state)
    _assert_summary(JSK.merge_sketches(jengine, jstate), SK.merge_sketches(engine, state))


def test_state_shapes_equal_jax():
    cfg, jcfg = _cfgs("sorted")
    for ours, theirs in (
            (SK.token_sketch_shapes(cfg.sketch, 4, chunk=8, device="cpu"),
             JSK.token_sketch_shapes(jcfg.sketch, 4, chunk=8)),
            (SK.expert_sketch_shapes(cfg.sketch, device="cpu"),
             JSK.expert_sketch_shapes(jcfg.sketch))):
        leaves = [ours.items, ours.counts, ours.errors, ours.buffer, ours.n]
        jleaves = jax.tree.leaves(theirs)
        jleaves = jleaves[:4] + jleaves[5:]              # fill is a host int here
        assert all(t.device.type == "meta" for t in leaves)
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves] == \
            [(j.shape, str(j.dtype)) for j in jleaves]
        assert ours.fill == 0
    assert SK.sketch_shardings(ShardingPlan(cfg), ours) is ours


def test_prefill_and_serve_steps_equal_jax():
    cfg, jcfg = _cfgs("sorted")
    b, prompt_len, gen = 4, 32, 16
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.build_params(cfg, "cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    plan, jplan = ShardingPlan(cfg, None), JShardingPlan(jcfg, None)
    assert S.sketch_groups(plan) == JS.sketch_groups(jplan) == 1
    prompt = TokenStream(cfg.vocab, b, prompt_len).next()["tokens"]

    jlast, jcache = jax.jit(JS.make_prefill_step(jcfg, jplan))(
        jp, {"tokens": jnp.asarray(prompt)})
    last, cache = S.make_prefill_step(cfg, plan)(model, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=2e-5)
    pad = gen
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) for k, v in cache.items()}

    jserve = jax.jit(JS.make_serve_step(jcfg, jplan))
    serve = S.make_serve_step(cfg, plan, device="cpu")
    jsk = JSK.init_token_sketch(jcfg.sketch, 1, chunk=b)
    sk = SK.init_token_sketch(cfg.sketch, 1, chunk=b, device="cpu")
    jtok = jnp.argmax(jlast, -1).astype(jnp.int32)[:, None]
    tok = last.argmax(-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for i in range(gen):
        jnxt, jcache, jsk = jserve(jp, jcache, jtok, prompt_len + i, jsk)
        nxt, cache, sk = serve(model, cache, tok, prompt_len + i, sk)
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt), err_msg=f"step {i}")
        _assert_state(jsk, sk)
        jtok, tok = jnxt[:, None], nxt[:, None]
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=0, atol=1e-4)


def _counts(tokens, n_ids):
    return np.bincount(tokens.reshape(-1), minlength=n_ids)


@pytest.mark.parametrize("kernel", ["torch", "sorted"])
def test_run_serve_sketch_equals_a_sorted_engine(kernel):
    cfg, _ = _cfgs(kernel)
    out = serve_cli.run_serve(cfg, batch=4, prompt_len=16, gen=20, report_every=8,
                              k_majority=8, device="cpu")
    tokens = out["tokens"]
    assert tokens.shape == (4, 20) and tokens.dtype == np.int32
    assert out["timings"]["prefill_ms"] is None and len(out["timings"]["step_host_s"]) == 20
    assert len(out["timings"]["sketch_host_s"]) == 20
    ref_cfg, _ = _cfgs("sorted")
    engine = SK.token_engine(ref_cfg.sketch, 1, device="cpu")
    ref = SK.init_token_sketch(ref_cfg.sketch, 1, chunk=4, device="cpu")
    for i in range(tokens.shape[1]):        # the same B tokens a step
        ref = SK.update_token_sketch(engine, ref, torch.from_numpy(tokens[:, i:i + 1]))
    for a, b in zip(state_to_numpy(out["sketch"]), state_to_numpy(ref)):
        np.testing.assert_array_equal(a, b)
    # the guarantees against exact counts: every f > n/k monitored,
    # lower <= f <= f_hat
    merged = SK.merge_sketches(engine, out["sketch"])
    f = _counts(tokens, cfg.vocab)
    n, k = int(out["sketch"].n.sum()), cfg.sketch.k_counters
    items, counts, errors = (t.numpy() for t in merged)
    live = items >= 0
    assert n == tokens.size
    assert set(np.flatnonzero(f > n // k)) <= set(items[live])
    assert (counts[live] - errors[live] <= f[items[live]]).all()
    assert (f[items[live]] <= counts[live]).all()
    # two reports, each a published version read through the ring
    assert [r["step"] for r in out["reports"]] == [8, 16]
    assert [r["version"] for r in out["reports"]] == [1, 2]
    assert [r["n"] for r in out["reports"]] == [32, 64]


def test_serve_cli_prints_trace_lines_and_metrics(capsys):
    before = obs_metrics.DEFAULT.describe()
    argv = ["--device", "cpu", "--arch", "qwen2.5-14b", "--smoke", "--batch", "2",
            "--prompt-len", "16", "--gen", "8", "--report-every", "4", "--metrics-dump"]
    assert serve_cli.main(argv) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    for name in ("serve.prefill.done", "serve.hot_tokens", "serve.decode.done",
                 "serve.sample"):
        assert any(ln.startswith(f"[{name}]") for ln in lines), name
    assert sum(ln.startswith("[serve.hot_tokens]") for ln in lines) == 2
    dump = json.loads(out[out.index("\n{") + 1:])
    metrics = dump["metrics"]

    def delta(name, key):
        return metrics[name][key] - before.get(name, {}).get(key, 0)
    assert delta("serve.decode.tokens", "value") == 16
    assert delta("serve.decode.step_s", "count") == 8
    names = {ev["name"] for ev in dump["events"]}
    assert {"serve.prefill", "serve.decode", "serve.report"} <= names


def test_run_serve_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot show")
    cfg, _ = _cfgs("sorted")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_cli.run_serve(cfg, batch=2, prompt_len=4, gen=2, device="cuda")


def test_serve_cli_imports_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.models.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
