"""Run one cell of the benchmark and print its result as the last line.

    python3 sketchbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``). With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Exits 2, printing no result, where the
card or cards the cell asks for are missing; 3 where a module of JAX or of
the JAX package was loaded. The line before the result is the run's
environment, also written to ``sketchbench_out/env.json``; the last lines
on standard error are the numbers compared, each beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def latency_ms(lat) -> str:
    import numpy as np
    if not lat:
        return "none"
    q = np.percentile(np.asarray(lat) * 1e3, [50, 90, 95, 99, 100])
    return "/".join(f"{x:.3f}" for x in q)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from sketchbench import harness
    t_imports = time.perf_counter() - T_START
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sketchbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {have}", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    t_card = time.perf_counter() - T_START
    result, verdict, record = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                       trace=bool(args.trace), device="cuda",
                                       t_start=T_START, card=card)
    bad = harness.forbidden_modules()
    if bad:
        print(f"sketchbench: the run loaded forbidden modules {bad}", file=sys.stderr)
        return 3
    env = harness.environment()
    out = ROOT / "sketchbench_out"
    out.mkdir(exist_ok=True)
    (out / "env.json").write_text(json.dumps(env, indent=1) + "\n")
    print("env " + json.dumps(env), flush=True)
    marks = " ".join(f"{k} {v:.3f}" for k, v in
                     dict(imports=t_imports, card=t_card, **record["setup_marks"]).items())
    print(f"sketchbench: {record['epochs']} epochs in {record['window_s']:.3f} s, set-up "
          f"{record['setup_s']:.3f} s (s from the start: {marks}), check "
          f"{record['check_s']:.3f} s; report latency ms p50/p90/p95/p99/max "
          f"{latency_ms(record['latencies_s'])}", file=sys.stderr)
    for name, v in verdict.items():
        print(f"check {name} {v['value']} limit {v['limit']} "
              f"{'ok' if v['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
