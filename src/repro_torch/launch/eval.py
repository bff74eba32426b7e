"""Accuracy-evaluation CLI of the port — the paper's accuracy tables.

Runs the sketch-vs-exact comparison (``repro_torch.eval.accuracy``) across
zipf skew × counter budget k × kernel impl through the main path
(SketchEngine → snapshot → QueryFrontend), prints ``name,value,derived``
CSV lines, and writes the record as JSON where ``--out`` says. ``--check``
turns the paper's correctness invariants (guaranteed-set recall == 1.0,
containment recall == 1.0, zero bound violations) into a nonzero exit.

  python -m repro_torch.launch.eval --check                       # on the card
  python -m repro_torch.launch.eval --device cpu --n 60000 --k 256 --check
  python -m repro_torch.launch.eval --device cpu --kernels fused,sorted --check
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.eval.accuracy import SKEWS, check_record, run_sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000, help="stream length per cell")
    ap.add_argument("--skews", default=",".join(str(s) for s in SKEWS),
                    help="comma list of zipf skews")
    ap.add_argument("--k", default="256,1024", help="comma list of counter budgets")
    ap.add_argument("--kernels", default=None,
                    help="comma list of merge/query impls (cuda, sorted, torch, "
                         "fused); default cuda,sorted,fused on the card, "
                         "torch,sorted on the CPU")
    ap.add_argument("--k-majority", type=int, default=0,
                    help="k-majority parameter; 0 → k per cell (the paper's "
                         "tight budget)")
    ap.add_argument("--tenants", type=int, default=4,
                    help="tenant shards the stream is decomposed over")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-id", type=int, default=10**6)
    ap.add_argument("--fold", default="mod", choices=("mod", "clip"),
                    help="tail-fold mode of the zipf generator")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every guarantee invariant holds")
    args = ap.parse_args(argv)
    if args.kernels is None:
        args.kernels = ("cuda,sorted,fused" if args.device.startswith("cuda")
                        else "torch,sorted")

    print("name,value,derived")

    def emit(name, value, derived=""):
        print(f"{name},{value},{derived}", flush=True)

    record = run_sweep(
        n=args.n,
        skews=[float(s) for s in args.skews.split(",")],
        ks=[int(k) for k in args.k.split(",")],
        impls=[i.strip() for i in args.kernels.split(",")],
        k_majority=args.k_majority or None,
        seed=args.seed, tenants=args.tenants, max_id=args.max_id,
        fold=args.fold, device=args.device, emit=emit)

    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=2) + "\n")
        emit("accuracy_json", args.out, "written")
    s = record["summary"]
    emit("min_guaranteed_recall", s["min_guaranteed_recall"])
    emit("min_recall", s["min_recall"])
    emit("max_are", s["max_are"])

    if args.check:
        failures = check_record(record)
        if failures:
            for f in failures:
                print(f"CHECK FAILED: {f}", file=sys.stderr)
            return 1
        print("check,ok,guaranteed-set + containment + bounds hold", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
