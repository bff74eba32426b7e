"""Match-weights on Hopper: a wrapper of ``csrc/ss_combine.cu``'s hash join.

Replaces the Pallas TPU kernel ``repro/kernels/ss_match.py:
match_weights_pallas``: the weight each summary slot gains from a histogram
and which histogram ids the summary monitors, the ``update`` op that the
plan's probes and the tune CLI time. Contract:
``kernels/ref.py:match_weights_ref``.

The function is combine-match without the errors channel: ``add_w`` is
``add_c`` and ``matched`` is ``matched_c`` for the histogram as the
candidates. So it launches ``ss_combine``'s kernels
(:func:`ss_combine.launch`) by the same shape rule
(:func:`ss_combine.kernel_for`): the shared-memory hash join where its table
fits (up to k = 8192 at either weight type), the dense compare above, so
any k is taken. Sums are taken in the weight type (int32 or int64) with wrap-around:
bitwise equal to :func:`match_weights_ref`, duplicate ids on either side
included, where the Pallas kernel summed as an f32 dot.

On a CPU tensor :func:`match_weights` computes the plain version; on a
CUDA tensor it launches a kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ss_combine
from repro_torch.kernels.ref import match_weights_ref

#: launches of a CUDA kernel by this wrapper in this process (one per launch)
LAUNCHES = 0


def _check(s_items, h_items, h_weights):
    dev = s_items.device
    for t in (s_items, h_items, h_weights):
        if t.device != dev:
            raise ValueError(f"match_weights: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("match_weights: the kernel takes contiguous tensors")
        if t.dim() < 1:
            raise ValueError("match_weights: tensors need a last axis")
    if s_items.dtype != torch.int32 or h_items.dtype != torch.int32:
        raise TypeError(f"match_weights: ids must be int32, got {s_items.dtype} "
                        f"and {h_items.dtype}")
    if h_weights.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"match_weights: weights must be int32 or int64, got "
                        f"{h_weights.dtype}")
    if h_weights.shape != h_items.shape:
        raise ValueError(f"match_weights: histogram shapes {tuple(h_items.shape)} "
                         f"vs {tuple(h_weights.shape)}")
    if s_items.shape[:-1] != h_items.shape[:-1]:
        raise ValueError(f"match_weights: batch dims {tuple(s_items.shape)} vs "
                         f"{tuple(h_items.shape)}")


def match_weights(s_items: torch.Tensor, h_items: torch.Tensor,
                  h_weights: torch.Tensor):
    """(add_w (..., k), matched (..., c) bool) for (..., k) vs (..., c)."""
    global LAUNCHES
    _check(s_items, h_items, h_weights)
    if s_items.device.type == "cpu":
        return match_weights_ref(s_items, h_items, h_weights)
    if s_items.device.type != "cuda":
        raise ValueError(f"match_weights: no kernel for {s_items.device}")
    b, k, c = s_items.shape[:-1].numel(), s_items.shape[-1], h_items.shape[-1]
    kernel = ss_combine.kernel_for(b, k, c, h_weights.dtype, False)
    if b == 0:
        return (torch.zeros(s_items.shape, dtype=h_weights.dtype, device=s_items.device),
                torch.zeros(h_items.shape, dtype=torch.bool, device=s_items.device))
    add_w, _, _, matched = ss_combine.launch(kernel, s_items, h_items, h_weights, None)
    LAUNCHES += 1
    return add_w, matched
