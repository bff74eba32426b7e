"""repro_torch.train.pipeline: the GPipe loop over a gloo world of S ranks.

The port of ``tests/test_pipeline.py``'s first case: S 4 stages of
tanh(a @ W + b), 8 micro-batches of 2 × 16; and the same at S 2. The ranks
run in a subprocess (``launch/mesh.spawn_ranks``, one process a rank); the
sequential computation and its gradients are JAX's, in this process, on
the same numpy inputs. Forward and grads within 1e-5 (the JAX test's
tolerance): the same f32 products, summed in other orders by XLA and ATen.
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

ROOT = Path(__file__).resolve().parents[1]
M, MB, D = 8, 2, 16

WORKER = r'''
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train.pipeline import pipeline_apply, pipelined_loss


def stage_fn(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def rank_fn(path):
    data = np.load(path)
    params = {"w": torch.from_numpy(data["w"]).requires_grad_(True),
              "b": torch.from_numpy(data["b"]).requires_grad_(True)}
    x, t = torch.from_numpy(data["x"]), torch.from_numpy(data["t"])
    m = x.shape[0]
    with torch.no_grad():
        out = pipeline_apply(stage_fn, params, x, n_micro=m)
    loss = pipelined_loss(stage_fn, lambda o, tt: ((o - tt) ** 2).mean(), params, x, t,
                          n_micro=m)
    loss.backward()
    grads = {}
    for name, p in params.items():
        g = p.grad.clone()
        dist.all_reduce(g)          # each rank holds its own stage's slice
        grads[name] = g.tolist()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"out": out.tolist(), "loss": loss.item(),
                                   "grads": grads})
    return every


if __name__ == "__main__":
    with open(sys.argv[2], "w") as f:
        json.dump(spawn_ranks(int(sys.argv[3]), rank_fn, sys.argv[1]), f)
'''


@pytest.mark.parametrize("S", [4, 2])
def test_pipeline_matches_sequential_and_grads(tmp_path, S):
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, D, D)) * 0.3, np.float32)
    bs = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (S, D)) * 0.1, np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (M, MB, D)), np.float32)
    t = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (M, MB, D)), np.float32)
    np.savez(tmp_path / "in.npz", w=ws, b=bs, x=x, t=t)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "in.npz"),
                        str(tmp_path / "out.json"), str(S)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    ranks = json.loads((tmp_path / "out.json").read_text())
    assert len(ranks) == S

    def seq(p, x):
        h = x
        for s in range(S):
            h = jnp.tanh(h @ p["w"][s] + p["b"][s])
        return h

    def seq_loss(p, x, t):
        return jnp.mean((seq(p, x) - t) ** 2)

    params = {"w": jnp.asarray(ws), "b": jnp.asarray(bs)}
    ref = np.asarray(seq(params, jnp.asarray(x)))
    ref_loss = float(seq_loss(params, jnp.asarray(x), jnp.asarray(t)))
    g_ref = jax.grad(seq_loss)(params, jnp.asarray(x), jnp.asarray(t))
    for rank in ranks:          # every rank holds the outputs, the loss and the grads
        np.testing.assert_allclose(np.asarray(rank["out"], np.float32), ref, atol=1e-5)
        assert abs(rank["loss"] - ref_loss) < 1e-5
        for name in ("w", "b"):
            np.testing.assert_allclose(np.asarray(rank["grads"][name], np.float32),
                                       np.asarray(g_ref[name]), atol=1e-5, err_msg=name)
