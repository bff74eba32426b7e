"""The table of peaks and the work of each kernel, counted from its shapes.

The least time of a piece of work is the larger of its bytes over the
card's memory rate and its operations over its scalar rate (NVIDIA's data
sheet for the H100 SXM at its 700 W limit). Bytes count each input read once
and each output written once; the counts come from the shapes of the work,
whatever implements it, never from a kernel's own tensors.

A summary slot is an int32 id, a count and an error in the count type.
"""
from __future__ import annotations

#: H100 SXM: HBM3 bytes per second, and 32-bit scalar operations per second
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "scalar_ops_per_s": 67e12}}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks(card: str | None = None) -> dict:
    return PEAKS.get(card or DEFAULT_CARD, PEAKS[DEFAULT_CARD])


def slot_bytes(count_bytes: int) -> int:
    return 4 + 2 * count_bytes


def flush_bytes(lanes: int, window: int, k: int, count_bytes: int) -> int:
    """A flush of every lane: the window read, each summary read and written."""
    return lanes * window * 4 + 2 * lanes * k * slot_bytes(count_bytes)


def flush_ops(lanes: int, window: int) -> int:
    """A flush's hash operations: one insert a window id."""
    return lanes * window


def merge_bytes(k: int, count_bytes: int) -> int:
    """One COMBINE of two summaries: both read, the result written."""
    return 3 * k * slot_bytes(count_bytes)


def merge_ops(k: int) -> int:
    """One COMBINE's hash operations: an insert and a probe a slot."""
    return 2 * k


def least_s(nbytes: float, ops: float, card: str | None = None) -> float:
    p = peaks(card)
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["scalar_ops_per_s"])


def flush_least_s(lanes, window, k, count_bytes, card=None) -> float:
    return least_s(flush_bytes(lanes, window, k, count_bytes), flush_ops(lanes, window), card)


def snapshot_least_s(lanes, k, count_bytes, card=None) -> float:
    """The COMBINE tree of ``lanes`` summaries: lanes − 1 merges."""
    merges = lanes - 1
    return least_s(merges * merge_bytes(k, count_bytes), merges * merge_ops(k), card)
