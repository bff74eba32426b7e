"""The readings that the limits of ``check.py`` are set from, on the card.

    python3 sketchbench/control.py --workload <name> --seeds <a,b,...>
        --control-seeds <c,d,e> --seconds <s> [--out <file.json>]

For each of ``--seeds`` it runs the cell as the benchmark does, with a
``--seconds`` window, and reads every number compared (the lower readings:
sound runs of the system). For each of ``--control-seeds`` it puts the
control in the system's place: the plain reference computed with 16-bit
counts, the nearest integer type below the configuration's int32, over as
many epochs as a run checks, and reads the same numbers (the upper
readings). The benchmark's own runs never run this.
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

#: the control's counts: the integer type below the configuration's
CONTROL_DTYPE = "int16"


def control_answers(cell, seed: int, device) -> tuple[list[dict], object]:
    """Answers of the reference at ``CONTROL_DTYPE`` for ``check.SAMPLE``
    epochs of the seed (the first ones), and the pool they came from."""
    import torch
    from sketchbench import check, reference, traffic
    cfg, mix = cell.config, cell.mix
    pool = traffic.make_pool(mix, seed, device)
    offsets = traffic.epoch_offsets(mix, seed, check.SAMPLE + 1)[1:]
    dtype = getattr(torch, CONTROL_DTYPE)
    answers = []
    for off in offsets:
        (items, counts, errors), n = reference.merged_epoch(
            check.epoch_blocks(pool, int(off), mix), k=cfg["k_counters"],
            lanes=cfg["lanes"], window=cfg["chunk"] * cfg["buffer_depth"],
            count_dtype=dtype)
        answers.append({"offset": int(off), "n": n, "summary": (items, counts, errors),
                        "report": reference.report(items, counts, errors, n, cfg["k_majority"]),
                        "top": reference.top(items, counts, cfg["top_n"])})
    return answers, pool


def control_numbers(cell, seed: int, device) -> dict:
    from sketchbench import check
    answers, pool = control_answers(cell, seed, device)
    numbers, failed = check.compare(answers, pool=pool, mix=cell.mix, config=cell.config,
                                    seed=seed)
    return dict(numbers, failed=failed, epochs=len(answers))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from sketchbench import check, harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    card = torch.cuda.get_device_name(0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        result, _, record = harness.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                                     device="cuda", t_start=t0, card=card)
        rows.append({"side": "system", "seed": seed, "correct": result["correct"],
                     "attempted": result["attempted"], "failed": result["failed"],
                     **{k: v["value"] for k, v in result["checks"].items()},
                     "check_s": record["check_s"], "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        t0 = time.perf_counter()
        rows.append({"side": "control", "seed": seed, **control_numbers(cell, seed, "cuda"),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
    readings = {}
    for name, limit in check.LIMITS.items():
        sys_v = [r[name] for r in rows if r["side"] == "system"]
        ctl_v = [r[name] for r in rows if r["side"] == "control"]
        # the lower reading is the largest of sound runs, the upper the
        # smallest of the control's
        readings[name] = {"limit": limit, "lower": max(sys_v, default=None),
                          "upper": min(ctl_v, default=None)}
    summary = {"workload": args.workload, "card": card, "readings": readings}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows, **summary}, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
