"""Checkpoint/restore with elastic resharding of the token sketch.

The counterpart of ``repro.checkpoint.manager``, with the same on-disk
layout, so that a checkpoint written by either package restores in the
other (one directory per step):

  <dir>/step_000123/
    manifest.json        — step, flat leaf paths, shapes/dtypes, data cursor
    arrays.npz           — one entry per leaf (copied to the host)
    _COMPLETE            — commit marker (atomic-rename publication)

Fault-tolerance contract, as in the JAX package:

  * writes are atomic: a crash mid-save never corrupts the latest
    checkpoint (tmp dir + rename, ``_COMPLETE`` written last);
  * restore picks a COMPLETE step, checks the structure and the shapes,
    and puts every leaf on the target device;
  * the Space Saving token sketch survives group-count changes by a
    COMBINE reduction (:func:`reshard_token_sketch`).

Leaves are found by :func:`_flatten`, which walks NamedTuples, dicts,
lists and tuples in ``jax.tree_util``'s order (dict keys sorted, ``None``
no leaf) and names every leaf with the path ``keystr`` gives
(``.summary.items``, ``['params']['w']``, ``[0]``). ``SketchState.fill``,
a Python int in the port, is a 0-d int32 leaf on disk, as the JAX state's
``fill`` is, and comes back as an int. bfloat16 leaves go to disk as their
uint16 bits (npz has no bfloat16), with "bfloat16" in the manifest.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.combine import reduce_summaries
from repro_torch.core.spacesaving import EMPTY, Summary
from repro_torch.engine.state import SketchState, flushed_summary, replayed_summary

def _flatten(tree):
    """``(paths, leaves, rebuild)``: the leaves in ``jax.tree_util``'s order,
    each path as ``keystr`` writes it, and ``rebuild(leaves)``, a tree of
    the same structure over new leaves."""
    paths, leaves = [], []

    def walk(node, path):
        if node is None:
            return lambda it: None
        if isinstance(node, tuple) and hasattr(node, "_fields"):     # NamedTuple
            make = type(node)
            if make is SketchState:
                node = node._replace(fill=np.int32(node.fill))
            subs = [walk(v, f"{path}.{f}") for f, v in zip(node._fields, node)]
            if make is SketchState:
                return lambda it: _int_fill(SketchState(*[s(it) for s in subs]))
            return lambda it: make(*[s(it) for s in subs])
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [walk(node[key], f"{path}[{key!r}]") for key in keys]
            make = type(node)
            return lambda it: make(zip(keys, [s(it) for s in subs]))
        if isinstance(node, (list, tuple)):
            subs = [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
            make = type(node)
            return lambda it: make([s(it) for s in subs])
        paths.append(path)
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree, "")
    return paths, leaves, lambda new_leaves: build(iter(new_leaves))


def _int_fill(state: SketchState) -> SketchState:
    return state._replace(fill=int(state.fill))


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array npz stores, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:       # npz can't round-trip bf16
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir, step: int, state, data_state: dict | None = None,
         keep: int = 3):
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    paths, leaves, _ = _flatten(state)
    arrays = {}
    dtypes = []
    for i, leaf in enumerate(leaves):
        arr, name = _to_host(leaf)
        dtypes.append(name)
        arrays[f"leaf_{i}"] = arr
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(np.shape(a)) for a in arrays.values()],
        "dtypes": dtypes,
        "data_state": data_state or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "_COMPLETE").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    complete = sorted(d for d in ckpt_dir.glob("step_*")
                      if (d / "_COMPLETE").exists())
    for old in complete[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(d.name.split("_")[1]) for d in ckpt_dir.glob("step_*")
                   if (d / "_COMPLETE").exists())
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, like_state, device=None):
    """Rebuild ``like_state``'s tree from disk; returns ``(state, data_state)``.

    Every tensor leaf takes the dtype of ``like_state``'s leaf and goes to
    ``device`` (``None``: the device of that leaf); a Python or numpy
    scalar leaf comes back as its own type.
    """
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / "_COMPLETE").exists():
        raise AssertionError(f"incomplete checkpoint {d}")
    manifest = json.loads((d / "manifest.json").read_text())
    arrays = np.load(d / "arrays.npz")

    paths, leaves, rebuild = _flatten(like_state)
    if manifest["paths"] != paths:
        raise AssertionError("checkpoint/state structure mismatch")

    out = []
    for i, ref in enumerate(leaves):
        a = arrays[f"leaf_{i}"]
        ref_shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(a.shape) != ref_shape:
            raise ValueError(
                f"leaf {paths[i]}: ckpt {a.shape} vs state {ref_shape} — "
                f"reshape via elastic helpers first")
        if isinstance(ref, torch.Tensor):
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))
            out.append(t.to(device=ref.device if device is None else device,
                            dtype=ref.dtype))
        elif isinstance(ref, np.generic | np.ndarray):
            out.append(np.asarray(a, dtype=ref.dtype)[()] if isinstance(ref, np.generic)
                       else np.asarray(a, dtype=ref.dtype))
        else:
            out.append(type(ref)(a.item()))
    return rebuild(out), manifest["data_state"]


# ---------------------------------------------------------------------------
# Elastic helpers
# ---------------------------------------------------------------------------

def reshard_token_sketch(sketch: SketchState, new_groups: int, *,
                         flush_mode: str = "deferred", match_fn=None,
                         window_fn=None, pair_fn=None) -> SketchState:
    """Re-group a (G-tenant) token sketch state for a different mesh size.

    Pending buffered chunks are merged first, with the owning engine's
    ``flush_mode`` and kernels (``EngineConfig.match_fn``/``window_fn``/
    ``pair_fn``: the window flush and the COMBINE rounds run the same
    kernels a live ``flush`` and ``merged`` would), then COMBINE reduces
    all old groups; seeding group 0 of the new layout preserves every
    summary bound (the other groups restart empty and re-fill from the
    live stream).
    """
    k = sketch.k
    if flush_mode == "deferred":
        view = flushed_summary(sketch, match_fn=match_fn, window_fn=window_fn)
    else:
        view = replayed_summary(sketch, match_fn=match_fn)
    merged = reduce_summaries(view, match_fn=match_fn, pair_fn=pair_fn)
    dev = sketch.buffer.device
    items = torch.full((new_groups, k), EMPTY, dtype=torch.int32, device=dev)
    counts = torch.zeros((new_groups, k), dtype=merged.counts.dtype, device=dev)
    errors = torch.zeros((new_groups, k), dtype=merged.errors.dtype, device=dev)
    items[0], counts[0], errors[0] = merged
    n = torch.zeros((new_groups,), dtype=sketch.n.dtype, device=dev)
    n[0] = sketch.n.sum()
    return SketchState(
        summary=Summary(items, counts, errors),
        buffer=torch.full((new_groups,) + tuple(sketch.buffer.shape[1:]), EMPTY,
                          dtype=torch.int32, device=dev),
        fill=0,
        n=n,
    )
