"""``repro_torch.launch.dryrun`` against the JAX package's record schema and
parameter counts. One subprocess (``OMP_NUM_THREADS=1``; its default
groups never enter the test worker) builds and counts:

  * the smoke arch of qwen2.5-14b on a fake world of 8 ranks, ``(2, 4)``
    ``data × model``: a train (B 8 × S 32), a prefill (B 8 × S 32) and a
    decode step (B 8, a cache of 64) (``count_step``);
  * mamba2-130m × ``decode_32k`` × ``single`` on the production mesh of a
    fake world of 256 ranks (``lower_cell``), and qwen2.5-14b ×
    ``long_500k``, which a full-attention arch skips.

The record's keys are JAX's (read from ``lower_cell``'s ``rec = {...}`` in
``src/repro/launch/dryrun.py``), its parameter counts JAX's
``param_count``, its bottleneck named, its memory fields ≥ 0, and a train
step's FLOPs at least the model's 6·N·tokens a device.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the fields lower_cell adds to count_step's
NAMES = {"arch", "shape", "mesh", "tag", "cfg_overrides"}


def jax_record_keys() -> set:
    """The keys of the JAX dry run's record, read from its source (importing
    it would force 512 host devices on this process's JAX)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "rec" for t in n.targets))
    return {k.value for k in rec.keys}


def cells() -> dict:
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.sharding.rules import ShardingPlan

    out = {}
    cfg = get_smoke_arch("qwen2.5-14b")
    dryrun.fake_world(8)
    plan = ShardingPlan(cfg, make_mesh_shape((2, 4), ("data", "model"), device_type="cpu"))
    for shape in (ShapeConfig("smoke_train", 32, 8, "train"),
                  ShapeConfig("smoke_prefill", 32, 8, "prefill"),
                  ShapeConfig("smoke_decode", 64, 8, "decode")):
        out[shape.kind] = dryrun.count_step(cfg, shape, plan, device="cpu")
    out["real"] = dryrun.lower_cell("mamba2-130m", "decode_32k", "single", device="cpu")
    out["long"] = dryrun.lower_cell("qwen2.5-14b", "long_500k", "single", device="cpu")
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _check(rec: dict, cfg) -> None:
    from repro.models.model import param_count
    assert rec["n_params"] == param_count(cfg)
    assert rec["n_active_params"] == param_count(cfg, active_only=True)
    assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert rec["roofline"]["step_lower_bound_s"] > 0
    assert all(v >= 0 for v in rec["memory"].values()), rec["memory"]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cell_on_a_fake_world_of_8(records, kind):
    from repro.configs.registry import get_smoke_arch
    rec = records[kind]
    assert set(rec) | NAMES == jax_record_keys()
    assert rec["kind"] == kind and rec["devices"] == 8
    assert rec["donate"] == (kind != "prefill")        # what the step updates in place
    _check(rec, get_smoke_arch("qwen2.5-14b"))
    # a (2, 4) mesh moves the FSDP weights and the heads' outputs
    assert rec["wire_bytes_per_device"] > 0 and "all-gather" in rec["collectives"]
    if kind == "train":
        assert rec["flops_per_device"] >= rec["model_flops_per_device"]
        assert rec["memory"]["alias_bytes"] > 0        # params, master, m, v in place


def test_real_cell_on_256_ranks(records):
    from repro.configs.registry import get_arch
    rec = records["real"]
    assert set(rec) == jax_record_keys()
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"]) == (
        "mamba2-130m", "decode_32k", "single", 256)
    assert rec["cfg_overrides"] == {"sketch_kernel": "sorted"}
    _check(rec, get_arch("mamba2-130m"))


def test_long_500k_skipped_for_full_attention(records):
    assert records["long"] == {"skipped": "pure full-attention arch (DESIGN.md §4)",
                               "arch": "qwen2.5-14b", "shape": "long_500k", "mesh": "single"}


if __name__ == "__main__":
    Path(sys.argv[1]).write_text(json.dumps(cells()))
