"""repro_torch.optim (AdamW, int8 compression) against repro.optim on the CPU.

  * ``adamw.update``: 5 steps with clipping active, against JAX's on the
    same numpy trees: params, master, m and v within 1e-6 relative (plus
    1e-7 absolute for entries near 0). Both sides run the same f32
    operations in the same order; the global norm sums its leaves in
    another order and the CPU kernels may fuse a multiply-add, a few ulps
    of f32 (6e-8 relative each). ``lr`` equal per step, ``count`` equal.
    The in-place form writes the live params from the master weights
    (bitwise ``master.to(dtype)``).
  * the cases of JAX's ``tests/test_optim.py``, ported;
  * ``quantize``: q and scale bitwise (``torch.round`` and ``jnp.round``
    both round half to even; the division is f32 on both sides);
  * ``compressed_psum`` and ``compressed_grad_reduce`` at p = 2 over gloo
    (a world of two spawned ranks in a subprocess), against JAX's
    ``compressed_psum`` under ``jax.vmap(..., axis_name=...)`` in this
    process, over 3 error-feedback steps: bitwise (integer sums of the int8
    payload, and the same f32 operations on two scales).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw
from repro_torch.optim.compression import dequantize, quantize

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "b": (rng.standard_normal((16,)) * scale).astype(np.float32),
            "c": (rng.standard_normal((3, 4, 5)) * scale).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got: dict, want: dict):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("in_place", [False, True])
def test_adamw_five_steps_equal_jax(rng, in_place):
    p0 = _tree(rng)
    params = _t(p0)
    state = adamw.init(params)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jadamw.init(jparams)
    lr_fn = adamw.cosine_schedule(1e-2, 2, 10)
    jlr_fn = jadamw.cosine_schedule(1e-2, 2, 10)
    for step in range(5):
        g = _tree(rng, scale=3.0)          # global norm ~ 50: clipping is active
        new, state, metrics = adamw.update(_t(g), state, torch.float32, lr_fn=lr_fn,
                                           params=params if in_place else None)
        jparams, jstate, jmetrics = jadamw.update({k: jnp.asarray(v) for k, v in g.items()},
                                                  jstate, jnp.float32, lr_fn=jlr_fn)
        assert float(jmetrics["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=RTOL)
        assert np.float32(metrics["lr"].item()) == np.float32(jmetrics["lr"]), step
        assert int(state.count) == int(jstate.count) == step + 1
        _close(new, jparams)
        _close(state.master, jstate.master)
        _close(state.m, jstate.m)
        _close(state.v, jstate.v)
        if in_place:
            assert all(new[k] is params[k] for k in params)
            assert all(torch.equal(params[k], state.master[k]) for k in params)


def test_in_place_bf16_params_are_their_masters(rng):
    params = {k: v.to(torch.bfloat16) for k, v in _t(_tree(rng)).items()}
    state = adamw.init(params)
    assert all(state.master[k].data_ptr() != params[k].data_ptr() for k in params)
    for _ in range(3):
        adamw.update({k: v.to(torch.bfloat16) for k, v in _t(_tree(rng)).items()}, state,
                     torch.bfloat16, lr_fn=lambda s: torch.tensor(1e-2), params=params)
        for k in params:
            assert params[k].dtype == torch.bfloat16
            assert torch.equal(params[k], state.master[k].to(torch.bfloat16)), k


def test_init_copies_f32_params():
    p = {"w": torch.ones(3)}
    state = adamw.init(p)
    assert state.master["w"].data_ptr() != p["w"].data_ptr()
    assert state.count.dtype == torch.int32 and int(state.count) == 0


# -- the cases of JAX's tests/test_optim.py ----------------------------------

def test_adamw_matches_manual_reference():
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    st = adamw.init(p)
    lr = 1e-2
    newp, st2, _ = adamw.update(g, st, torch.float32,
                                lr_fn=lambda s: torch.tensor(lr, dtype=torch.float32),
                                b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                                clip_norm=1e9)
    gm = g["w"].numpy()
    m = 0.1 * gm
    v = 0.001 * gm * gm
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.999)
    ref = p["w"].numpy() - lr * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), ref, atol=1e-6)
    assert int(st2.count) == 1


def test_weight_decay_decoupled():
    p = {"w": torch.ones(2)}
    g = {"w": torch.zeros(2)}
    st = adamw.init(p)
    newp, _, _ = adamw.update(g, st, torch.float32, lr_fn=lambda s: torch.tensor(0.1),
                              weight_decay=0.5, clip_norm=1e9)
    np.testing.assert_allclose(newp["w"].numpy(), 0.95 * np.ones(2), atol=1e-6)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 10.0) < 1e-5
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-5


def test_cosine_schedule_shape():
    lr = adamw.cosine_schedule(1.0, warmup=10, total=110, min_frac=0.1)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(lr(torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(lr(torch.tensor(110, dtype=torch.int32))) <= 0.1 + 1e-6
    assert float(lr(torch.tensor(60, dtype=torch.int32))) < 1.0


def test_cosine_schedule_equals_jax():
    lr = adamw.cosine_schedule(3e-4, 20, 16)
    jlr = jadamw.cosine_schedule(3e-4, 20, 16)
    for step in range(0, 40):
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == np.float32(jlr(jnp.int32(step))), step


def test_quantize_roundtrip_bounded_error(rng):
    x = torch.from_numpy((rng.standard_normal(1000) * 5).astype(np.float32))
    q, s = quantize(x)
    err = (dequantize(q, s) - x).abs().numpy()
    assert err.max() <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates():
    """With error feedback the cumulative applied update converges to the
    true gradient sum, though each step is quantized."""
    g = torch.full((64,), 0.003)
    residual = torch.zeros_like(g)
    applied = torch.zeros_like(g)
    for _ in range(50):
        total = g + residual
        q, s = quantize(total)
        deq = dequantize(q, s)
        residual = total - deq
        applied = applied + deq
    np.testing.assert_allclose(applied.numpy(), 50 * 0.003, rtol=0.02)


@pytest.mark.parametrize("case", ["normal", "halves", "zeros", "tiny"])
def test_quantize_bitwise_equal_jax(rng, case):
    x = {"normal": rng.standard_normal(4096) * 7,
         "halves": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5]),
         "zeros": np.zeros(16),
         "tiny": rng.standard_normal(64) * 1e-14}[case].astype(np.float32)
    q, s = quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(dequantize(q, s).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))


# -- compressed_psum over gloo at p = 2 ----------------------------------------

WORKER = r'''
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import spawn_ranks
from repro_torch.optim.compression import (compressed_grad_reduce, compressed_psum,
                                           init_residuals)


def rank_fn(path):
    data = np.load(path)
    r = dist.get_rank()
    res = torch.zeros(data["g"].shape[2:], dtype=torch.float32)
    grads, tree_res = None, None
    out = []
    for step in range(data["g"].shape[0]):
        red, res = compressed_psum(torch.from_numpy(data["g"][step, r]), res)
        g = {"x": torch.from_numpy(data["g"][step, r]), "y": torch.from_numpy(data["h"][r])}
        if tree_res is None:
            tree_res = init_residuals(g)
        grads, tree_res = compressed_grad_reduce(g, tree_res)
        out.append({"red": red.tolist(), "res": res.tolist(),
                    "tree": {k: v.tolist() for k, v in grads.items()},
                    "tree_res": {k: v.tolist() for k, v in tree_res.items()}})
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


if __name__ == "__main__":
    with open(sys.argv[2], "w") as f:
        json.dump(spawn_ranks(2, rank_fn, sys.argv[1]), f)
'''


def test_compressed_psum_over_gloo_equals_jax(tmp_path, rng):
    steps, p, n = 3, 2, 257
    g = (rng.standard_normal((steps, p, n)) * np.array([1.0, 40.0])[None, :, None]
         ).astype(np.float32)
    h = rng.standard_normal((p, 5)).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, h=h)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "in.npz"),
                        str(tmp_path / "out.json")], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    ranks = json.loads((tmp_path / "out.json").read_text())

    psum = jax.vmap(lambda gg, rr: jcomp.compressed_psum(gg, rr, "pod"), axis_name="pod")
    tree = jax.vmap(lambda gg, rr: jcomp.compressed_grad_reduce(gg, rr, "pod"),
                    axis_name="pod")
    res = jnp.zeros((p, n), jnp.float32)
    tree_res = {"x": jnp.zeros((p, n), jnp.float32), "y": jnp.zeros((p, 5), jnp.float32)}
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    for step in range(steps):
        red, res = psum(jnp.asarray(g[step]), res)
        tg, tree_res = tree({"x": jnp.asarray(g[step]), "y": jnp.asarray(h)}, tree_res)
        for rank in range(p):
            got = ranks[rank][step]
            np.testing.assert_array_equal(f32(got["red"]), np.asarray(red[rank]))
            np.testing.assert_array_equal(f32(got["res"]), np.asarray(res[rank]))
            for k in ("x", "y"):
                np.testing.assert_array_equal(f32(got["tree"][k]), np.asarray(tg[k][rank]))
                np.testing.assert_array_equal(f32(got["tree_res"][k]),
                                              np.asarray(tree_res[k][rank]))
