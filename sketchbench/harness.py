"""Resolve a cell of ``BENCHMARK.json`` by name and run it.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by its name in the manifest:

  configs: the ``file`` that the manifest's ``configs`` entry names
  traffic/<traffic>.json          a mix, read by runners/<runner>.py
  metrics/<metric>.py             ``read(run) -> float | None``

A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""
from __future__ import annotations

import importlib.util
import json
import os
import platform
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, mix and metrics."""

    def __init__(self, name: str, bench: dict | None = None, *, root: Path = ROOT,
                 bench_dir: Path = HERE):
        bench = manifest(root) if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.name, self.workload = name, cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.workload["config"]]["file"])
        self.mix = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])
        self.bench_dir = bench_dir
        self.metrics = {kind: [m for m in bench[kind]
                               if "workloads" not in m or name in m["workloads"]]
                        for kind in ("end_to_end", "per_layer")}

    def runner(self):
        return _load_module(self.bench_dir / "runners" / f"{self.mix['runner']}.py",
                            f"sketchbench.runners.{self.mix['runner']}")

    def reader(self, metric: str):
        return _load_module(self.bench_dir / "metrics" / f"{metric}.py",
                            f"sketchbench.metrics.{metric}")


class Run:
    """What a metric reader sees: the cell, the runner's record and the card."""

    def __init__(self, cell: Cell, record: dict, card: str | None):
        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.record, self.trace, self.card = record, record.get("trace"), card


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, card: str | None = None) -> tuple[dict, dict, dict]:
    """Run a cell; return (the result line, the verdict of each number
    compared, the runner's record)."""
    from sketchbench import check
    record = cell.runner().run(cell.config, cell.mix, seed=seed, seconds=seconds,
                               trace=trace, device=device, t_start=t_start)
    run = Run(cell, record, card)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = check.verdict(record["numbers"])
    correct = all(v["ok"] for v in verdict.values()) and record["failed"] == 0
    dev = {"platform": "gpu" if card else "cpu", "kind": card or platform.machine(),
           "count": cell.chips, "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": dev}
    tr = record.get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s()
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in verdict.items()}
    return result, verdict, record


# -- the run's environment ----------------------------------------------------

def _command(*argv) -> str:
    if shutil.which(argv[0]) is None and not Path(argv[0]).is_file():
        return "not found"
    try:
        out = subprocess.run(argv, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def environment() -> dict:
    """The card, its power limit, torch, numpy, nvcc and the host's CPUs."""
    import numpy
    import torch
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                       / "bin" / "nvcc")
    nv = _command(nvcc, "--version").splitlines()
    smi = _command("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    return {"card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
            "nvidia_smi": smi.splitlines(), "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "numpy": numpy.__version__,
            "nvcc": nv[-1] if nv else "", "python": platform.python_version(),
            "cpu_count": os.cpu_count()}
