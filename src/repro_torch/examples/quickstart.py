"""Quickstart: the paper's algorithm in five lines, then the framework view.

The counterpart of ``examples/quickstart.py``, with its sizes and lines.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import frequent_items, parallel_spacesaving
from repro_torch.core.exact import evaluate
from repro_torch.core.spacesaving import sort_summary
from repro_torch.data.synthetic import zipf_stream
from repro_torch.examples import check_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = check_device(ap.parse_args(argv).device)

    # --- 1. k-majority on a zipf stream (paper Algorithm 1) ----------------
    stream = zipf_stream(500_000, skew=1.1, seed=0, max_id=10**6)
    items, counts, candidates, guaranteed = frequent_items(
        torch.from_numpy(stream), k_majority=100, counters=1000, p=8, device=device)

    print("k-majority candidates (item: f̂):")
    for i, c, is_cand, is_guar in zip(*(t.cpu().numpy() for t in
                                        (items, counts, candidates, guaranteed))):
        if is_cand:
            print(f"  {int(i):8d}: {int(c):8d}  {'guaranteed' if is_guar else ''}")

    # --- 2. verify against the exact oracle --------------------------------
    summary = parallel_spacesaving(torch.from_numpy(stream), k=1000, p=8, device=device)
    m = evaluate(summary, stream, 100)
    print(f"\nvs exact counts: ARE={m.are:.2e} precision={m.precision:.2f} "
          f"recall={m.recall:.2f}")

    # --- 3. the summary itself (top counters) ------------------------------
    top = sort_summary(summary, ascending=False)
    items, counts, errors = (np.asarray(t.cpu()) for t in (top.items, top.counts, top.errors))
    print("\ntop-5 counters (item, f̂, ε):")
    for i in range(5):
        print(f"  {int(items[i]):8d}  {int(counts[i]):8d} ± {int(errors[i])}")


if __name__ == "__main__":
    main()
