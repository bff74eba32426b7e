"""The flushes' least time from their shapes over the device time of every
operation launched inside the ingest spans (traced sub-window)."""
import torch

from sketchbench import roofline


def read(run):
    tr, cfg = run.trace, run.config
    dev = None if tr is None else tr.span_device_s("ingest")
    if not dev:
        return None
    window = cfg["chunk"] * cfg["buffer_depth"]
    flushes = run.record["traced_items"] / (cfg["lanes"] * window)
    count_bytes = torch.empty((), dtype=getattr(torch, cfg["count_dtype"])).element_size()
    least = flushes * roofline.flush_least_s(cfg["lanes"], window, cfg["k_counters"],
                                             count_bytes, run.card)
    return least / dev * 100
