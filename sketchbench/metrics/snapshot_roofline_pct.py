"""The COMBINE tree's least time (lanes − 1 merges of two summaries into one)
over the device time of the operations launched inside the snapshot spans."""
import torch

from sketchbench import roofline


def read(run):
    tr, cfg = run.trace, run.config
    dev = None if tr is None else tr.span_device_s("snapshot")
    if not dev:
        return None
    count_bytes = torch.empty((), dtype=getattr(torch, cfg["count_dtype"])).element_size()
    least = tr.span_count("snapshot") * roofline.snapshot_least_s(
        cfg["lanes"], cfg["k_counters"], count_bytes, run.card)
    return least / dev * 100
