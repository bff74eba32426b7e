"""BENCHMARK.json against the benchmark's contract, and the harness's lookup by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from sketchbench import harness
from sketchbench.tests.conftest import ROOT, TINY_CONFIG, TINY_MIX

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_entry_keys():
    assert set(BENCH) == TOP_KEYS
    for kind, (need, may) in ENTRY_KEYS.items():
        for entry in BENCH[kind]:
            assert need <= set(entry) <= need | may, (kind, entry)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if kind == "configs" else ()):
            if key in e:
                assert _line(e[key]), (key, e[key])
    assert len(BENCH[kind]) >= 1


def test_metric_names_unique_across_kinds_and_sources():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_command_paths_and_budget():
    assert BENCH["command"] == ["python3", "sketchbench/run.py"]
    assert BENCH["paths"] == ["sketchbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43 200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_pairs_chips_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(name):
    cell = harness.Cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.mix["name"] == cell.workload["traffic"]
    assert callable(cell.runner().run)
    for kind in ("end_to_end", "per_layer"):
        assert cell.metrics[kind], kind
        for m in cell.metrics[kind]:
            assert callable(cell.reader(m["name"]).read)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.workload["config"])
    assert entry["file"].startswith("sketchbench/") and entry["source"] == cell.config["source"]
    assert entry["reduced"] == cell.config["reduced"]


def test_config_files_are_distinct_and_sources_differ():
    files = [c["file"] for c in BENCH["configs"]]
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and len(set(sources)) == len(sources)


def test_a_new_mix_config_and_metric_are_files_and_entries_only(tmp_path):
    """A later cell adds files and manifest entries; nothing already there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "sketchbench", root / "sketchbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "sketchbench/configs/paper-k2000.json").read_text())
    cfg.update(TINY_CONFIG, name="tiny-k64")
    (root / "sketchbench/configs/tiny-k64.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "sketchbench/traffic/epoch256m.zipf11.json").read_text())
    mix.update(TINY_MIX, name="epoch16k.zipf13", skew=1.3)
    (root / "sketchbench/traffic/epoch16k.zipf13.json").write_text(json.dumps(mix))
    (root / "sketchbench/metrics/epochs_in_window.py").write_text(
        "def read(run):\n    return float(run.record['epochs'])\n")
    bench["configs"].append({"name": "tiny-k64", "source": "a test", "reduced": [],
                             "file": "sketchbench/configs/tiny-k64.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.epoch16k.zipf13", "config": "tiny-k64",
                               "traffic": "epoch16k.zipf13", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "epochs_in_window", "unit": "epochs",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.epoch16k.zipf13"]})
    cell = harness.Cell("tiny.epoch16k.zipf13", bench, root=root,
                        bench_dir=root / "sketchbench")
    assert cell.mix["skew"] == 1.3 and cell.config["k_counters"] == 64
    result, verdict, record = harness.run_cell(cell, seed=11, seconds=0.2, trace=False,
                                               device="cpu", t_start=0.0)
    assert result["correct"], verdict
    assert result["metrics"]["epochs_in_window"]["value"] == record["epochs"] >= 1
    assert "epochs_in_window" not in harness.Cell("k2000.epoch256m.zipf11", bench,
                                                  root=root).metrics["end_to_end"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like.sub", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake_sub", sys)
    monkeypatch.setitem(sys.modules, "repro.fake_sub", sys)
    assert set(harness.forbidden_modules()) == before | {"jaxlib", "repro"}


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run of a cell, in a process of its own, loads none of them."""
    code = (
        "import sys; sys.path[:0] = [{src!r}, {root!r}]\n"
        "from sketchbench.tests.conftest import tiny\n"
        "from sketchbench import harness\n"
        "r, v, rec = harness.run_cell(tiny(), seed=5, seconds=0.2, trace=True,"
        " device='cpu', t_start=0.0)\n"
        "assert r['correct'], v\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n"
    ).format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_means_no_result_and_a_nonzero_exit():
    out = subprocess.run([sys.executable, "sketchbench/run.py", "--workload",
                          "k2000.epoch256m.zipf11", "--seed", str(2**31 + 7), "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
