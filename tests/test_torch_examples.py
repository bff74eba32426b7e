"""The port's four examples (``repro_torch.examples``) against the JAX
scripts of ``examples/``, on the CPU, each script in a subprocess
(``OMP_NUM_THREADS=1``, the port's plan cache under ``tmp_path``), a JAX
script and its twin run at once:

  * ``quickstart``: its standard output equals ``examples/quickstart.py``'s
    under ``JAX_PLATFORMS=cpu``, line for line;
  * ``stream_frequent_items``: every line but the tier's ``describe()``
    (items, counts, bounds, versions, the k-majority tally) equals the JAX
    script's;
  * ``serve_decode`` (``--gen 4``) and ``train_lm_with_sketch``
    (``--steps 4``, a ``tmp_path`` checkpoint directory) exit 0, the trainer
    with its exact-oracle line at precision and recall 1.000 and a
    checkpoint of step 4;
  * each twin refuses ``--device cuda`` where no card is;
  * quickstart's stream has this machine's digest (``chip_smoke.py`` phase
    20 prints the card machine's beside its numpy version).
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import zipf_stream

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "stream_frequent_items", "serve_decode", "train_lm_with_sketch")


def _env(tmp_path) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               REPRO_TORCH_PLAN_CACHE=str(tmp_path / "plans"),
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("REPRO_TORCH_PLAN_FILE", None)
    return env


def _run(tmp_path, *commands) -> list:
    """The standard outputs of ``commands`` (argument lists after the
    interpreter), run at once in ``tmp_path``; each must exit 0."""
    procs = [subprocess.Popen([sys.executable, *cmd], cwd=tmp_path, env=_env(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in commands]
    outs = []
    for cmd, proc in zip(commands, procs):
        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, (cmd, err[-3000:])
        outs.append(out)
    return outs


def test_quickstart_prints_the_jax_scripts_lines(tmp_path):
    jax_out, port_out = _run(tmp_path, [str(ROOT / "examples/quickstart.py")],
                             ["-m", "repro_torch.examples.quickstart", "--device", "cpu"])
    assert "recall=1.00" in port_out
    assert port_out.splitlines() == jax_out.splitlines()


def test_stream_frequent_items_lines_equal_the_jax_scripts(tmp_path):
    jax_out, port_out = _run(tmp_path, [str(ROOT / "examples/stream_frequent_items.py")],
                             ["-m", "repro_torch.examples.stream_frequent_items",
                              "--device", "cpu"])
    jax_lines, port_lines = jax_out.splitlines(), port_out.splitlines()
    assert port_lines[-1].startswith("tier: {") and jax_lines[-1].startswith("tier: {")
    assert "100-majority" in port_out and "queries @ v" in port_out
    assert port_lines[:-1] == jax_lines[:-1]


def test_serve_decode_twin_runs(tmp_path):
    out, = _run(tmp_path, ["-m", "repro_torch.examples.serve_decode", "--gen", "4",
                           "--device", "cpu"])
    assert "[serve.decode.done] gen=4 batch=4" in out and '"metrics"' in out


def test_train_lm_with_sketch_twin_runs(tmp_path):
    ckpt = tmp_path / "ck"
    out, = _run(tmp_path, ["-m", "repro_torch.examples.train_lm_with_sketch", "--steps", "4",
                           "--ckpt-dir", str(ckpt), "--device", "cpu"])
    final = next(line for line in out.splitlines() if line.startswith("[sketch-final]"))
    assert "precision=1.000 recall=1.000" in final
    assert (ckpt / "mamba2-130m" / "step_00000004" / "_COMPLETE").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal where no card is")
@pytest.mark.parametrize("name", TWINS)
def test_twins_refuse_cuda_without_a_card(name, tmp_path, monkeypatch):
    import importlib
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    main = importlib.import_module(f"repro_torch.examples.{name}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--device", "cuda", "--ckpt-dir", str(tmp_path / "ck")]
             if name == "train_lm_with_sketch" else ["--device", "cuda"])


# sha256 of zipf_stream(500_000, skew=1.1, seed=0, max_id=10**6), int32 bytes,
# under numpy 2.0.2 (its Generator.zipf draws): item 1 appears 47 408 times
QUICKSTART_STREAM_SHA256 = "122abfe0f7d7a28e71e8320b6a43497f260604e81eda721b86e88c498232c365"


def test_quickstart_stream_digest():
    """The stream quickstart counts, pinned by its digest and item 1's exact
    count; printed with numpy's version, so that a machine whose quickstart
    prints another count can be told apart by its stream."""
    stream = zipf_stream(500_000, skew=1.1, seed=0, max_id=10**6)
    digest = hashlib.sha256(np.ascontiguousarray(stream).tobytes()).hexdigest()
    print(f"numpy {np.__version__} quickstart stream sha256 {digest}")
    assert stream.dtype == np.int32 and int((stream == 1).sum()) == 47408
    assert digest == QUICKSTART_STREAM_SHA256
