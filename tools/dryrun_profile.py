"""Where the host time of one dry-run cell goes: the cell's counted step
(``launch/dryrun.count_step`` under ``--auto``'s policy) run once under
``cProfile``.

    PYTHONPATH=src python tools/dryrun_profile.py --arch qwen1.5-110b \\
        --shape prefill_32k --mesh pod [--device cpu] [--slowest results/dryrun_torch]

``--slowest DIR`` takes, in place of ``--arch``/``--shape``/``--mesh``,
the ``prefill_32k`` cell of the records in ``DIR`` whose ``compile_s`` is
the largest. Prints one JSON line: the cell, its ``lower_s`` and
``compile_s`` (the record's fields, this run), the profiled seconds, the
profile's own seconds summed by layer (a module of the port; torch's
package two levels deep, such as ``torch/_subclasses`` for the fake
tensors and ``torch/distributed/tensor`` for DTensor; Python's builtins)
and the ``--top`` functions by their own seconds, then the card's name and power limit where a card is.
"""
from __future__ import annotations

import argparse
import collections
import cProfile
import json
import pstats
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.launch import dryrun


def _group(path: str) -> str:
    """The layer a profiled function's file belongs to: a module of the
    port, torch's package two levels deep, or Python's builtins."""
    parts = Path(path).parts
    if "repro_torch" in parts:
        return "/".join(parts[parts.index("repro_torch"):])
    if "torch" in parts:
        return "/".join(parts[parts.index("torch"):][:3])
    return "builtins" if path == "~" else "python"


def slowest_prefill(records: Path) -> tuple:
    recs = [json.loads(p.read_text()) for p in records.glob("*__prefill_32k__*.json")
            if not p.name.endswith(".error.json")]
    rec = max((r for r in recs if "compile_s" in r), key=lambda r: r["compile_s"])
    return rec["arch"], rec["shape"], rec["mesh"], rec["compile_s"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--mesh", default="single", choices=["single", "pod"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slowest", default=None, type=Path)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    matrix_s = None
    if args.slowest is not None:
        args.arch, args.shape, args.mesh, matrix_s = slowest_prefill(args.slowest)
    opts, over, schedule = dryrun.auto_policy(args.arch, args.shape, args.mesh, {})
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    rec = dryrun.lower_cell(args.arch, args.shape, args.mesh, opts=opts, schedule=schedule,
                            cfg_overrides=over, device=args.device)
    prof.disable()
    seconds = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = [(f"{Path(f).name}:{line}({name})", calls, own, _group(f))
            for (f, line, name), (calls, _, own, _, _) in stats.items()]
    groups = collections.Counter()
    for _, _, own, group in rows:
        groups[group] += own
    print(json.dumps({"cell": [args.arch, args.shape, args.mesh], "device": args.device,
                      "lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
                      "matrix_compile_s": matrix_s, "profiled_s": seconds,
                      "own_s_by_layer": {g: round(t, 3) for g, t in groups.most_common()},
                      "top_own": [{"fn": fn, "calls": calls, "own_s": round(own, 3)}
                                  for fn, calls, own, _ in sorted(rows, key=lambda r: -r[2])
                                  [:args.top]]}), flush=True)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())


if __name__ == "__main__":
    main()
