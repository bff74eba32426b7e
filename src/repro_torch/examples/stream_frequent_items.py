"""Streaming frequent items through the concurrent serving tier.

The counterpart of ``examples/stream_frequent_items.py``, with its
``ServeConfig``. The ServingTier owns the whole write/read split: host
stream blocks go through a bounded admission queue into an IngestLoop
thread (a CUDA stream of its own on the card) that drives the
StreamRuntime's ingestion path (block decomposition over shards × lanes
workers, staging onto the device, merges deferred over ``buffer_depth``
chunks) and publishes versioned snapshots into a SnapshotRing every
``publish_every`` blocks. Reads never touch the write path: the ring's
ServeFrontend answers top-n / point / k-majority queries from the newest
complete version.

  PYTHONPATH=src python -m repro_torch.examples.stream_frequent_items [--device cpu]
"""
import argparse

from repro_torch.data.synthetic import zipf_stream
from repro_torch.engine import EngineConfig
from repro_torch.examples import check_device
from repro_torch.runtime import RuntimeConfig
from repro_torch.serve import ServeConfig, ServingTier

K = 512
LANES = 8            # sketch lanes per shard (the OpenMP level)
CHUNK = 4096
DEPTH = 4            # chunks buffered per deferred merge


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = check_device(ap.parse_args(argv).device)
    config = ServeConfig(
        runtime=RuntimeConfig(
            engine=EngineConfig(k=K, tenants=LANES, chunk=CHUNK, buffer_depth=DEPTH,
                                reduction="hierarchical", device=str(device)),
            shards=None),    # None → the world size (1 on one card)
        publish_every=5,     # ring version every 5 admitted blocks
        queue_depth=8)       # bounded admission: submit() backpressures

    with ServingTier(config) as tier:
        runtime = tier.runtime
        print(f"streaming 40 blocks × {runtime.workers} workers "
              f"({runtime.shards} shard(s) × {LANES} lanes) × {CHUNK} items "
              f"(merges deferred {DEPTH}×, publish every "
              f"{tier.publish_every} blocks)")
        for step in range(4):
            for i in range(10):
                tier.submit(zipf_stream(runtime.workers * CHUNK, 1.1,
                                        seed=10 * step + i, max_id=10**6))
            # drain() ingests everything admitted so far and publishes
            # exactly that position; reads below come from the ring
            snap = tier.drain()
            top = tier.frontend.top_table(3)
            print(f"  after {int(snap.n):9,d} items (snapshot v{top.version}), "
                  f"top-3:", [(r["item"], r["count"]) for r in top.rows])

        # frequency queries + the paper's guarantee-split k-majority report,
        # all answered from the ring's newest complete version
        queries = [1, 2, 3, 50, 999_999]
        est = tier.frontend.estimate(queries)
        print(f"\nqueries @ v{est.version} (item -> f̂ [lower bound] monitored?):")
        for q, f, lo, mon in zip(queries, est.f_hat, est.lower, est.monitored):
            print(f"  {int(q):8d} -> {int(f):9d} [{int(lo):9d}] {bool(mon)}")

        report = tier.frontend.k_majority_report(100)
        print(f"\n100-majority (threshold {report.threshold:,d} of "
              f"n={report.n:,d}): {report.guaranteed_items.size} guaranteed, "
              f"{report.unconfirmed_items.size} unconfirmed candidates")
        print("\ntier:", tier.describe())


if __name__ == "__main__":
    main()
