"""Carry parameters between the JAX package's layout and the port's.

The one place where the two layouts meet. The JAX package keeps a layer
stack as one (L, ...) leaf per parameter under ``params["layers"]``, with
flat names (``attn_norm_scale``, ``wq``, ``wdkv``, ``router``, ``w_gate``...);
the port keeps one :class:`~repro_torch.models.model.Block` per layer with
the same matrices, also (in, out), and the expert stacks (E, D, F) as they
are, so no leaf is transposed: each stacked leaf is split per layer and
renamed. ``w_gate``/``w_up``/``w_down`` name the MLP's matrices and the
MoE's expert stacks alike; they go to whichever module the block holds. ``bfloat16`` numpy arrays (``ml_dtypes``)
travel as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import check_family

# JAX flat layer name prefix -> the port's submodule
_LAYER_PREFIXES = (("attn_norm_", "attn_norm."), ("mlp_norm_", "mlp_norm."))
_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLA = ("wdq", "q_norm_scale", "wuq", "wdkv", "kv_norm_scale", "wuk", "wuv", "wo")
_MLP = ("w_gate", "w_up", "w_down", "b_up", "b_down")
_MOE = ("router", "w_gate", "w_up", "w_down")


def _layer_name(cfg, name: str) -> str:
    for jax_prefix, port_prefix in _LAYER_PREFIXES:
        if name.startswith(jax_prefix):
            return port_prefix + name[len(jax_prefix):]
    if name in (_MLA if cfg.mla is not None else _ATTN):
        return "attn." + name
    if name in (_MOE if cfg.moe is not None else _MLP):
        return ("moe." if cfg.moe is not None else "mlp.") + name
    raise KeyError(f"no port parameter for the JAX layer leaf {name!r}")


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def unstack_params(cfg, tree: dict) -> dict:
    """A tree in the JAX package's layout (tensor leaves, layers stacked on
    a leading dim) as the port's ``state_dict`` keys: each stacked leaf is
    split per layer (views of it) and renamed."""
    check_family(cfg)
    out = {}
    for name, leaf in tree.items():
        if name == "layers":
            for lname, stacked in leaf.items():
                port = _layer_name(cfg, lname)
                for i in range(stacked.shape[0]):
                    out[f"layers.{i}.{port}"] = stacked[i]
        elif name.startswith("final_norm_"):
            out["final_norm." + name[len("final_norm_"):]] = leaf
        elif name in ("embed", "lm_head"):
            out[name] = leaf
        else:
            raise KeyError(f"no port parameter for the JAX leaf {name!r}")
    return out


def stack_params(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`unstack_params`: tensors under the port's
    ``state_dict`` keys as the JAX package's tree, layers stacked
    (``torch.stack``, on the tensors' device; ``meta`` tensors stay
    ``meta``). The train checkpoints carry params, master weights and
    moments in this layout, so either package restores them."""
    check_family(cfg)
    tree: dict = {}
    per_layer: dict = {}
    inverse = {port: jax for jax, port in _LAYER_PREFIXES}
    for name, t in state_dict.items():
        if name.startswith("layers."):
            _, i, port = name.split(".", 2)
            head, _, tail = port.partition(".")
            jax_name = inverse.get(head + ".", "") + tail
            per_layer.setdefault(jax_name, {})[int(i)] = t
        elif name.startswith("final_norm."):
            tree["final_norm_" + name[len("final_norm."):]] = t
        else:
            tree[name] = t
    tree["layers"] = {name: torch.stack([by_layer[i] for i in range(len(by_layer))])
                      for name, by_layer in per_layer.items()}
    return tree


def params_from_jax(cfg, tree: dict) -> dict:
    """The JAX package's ``init_params`` tree (numpy leaves) as the port's
    ``state_dict`` (CPU tensors, the leaves' dtypes)."""
    tree = {name: ({n: _to_torch(a) for n, a in leaf.items()} if name == "layers"
                   else _to_torch(leaf)) for name, leaf in tree.items()}
    return {name: t.clone() for name, t in unstack_params(cfg, tree).items()}


def params_to_jax(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` as the JAX
    package's tree of numpy leaves, layers stacked on a leading dim."""
    tree = stack_params(cfg, {n: t.detach().cpu() for n, t in state_dict.items()})
    return {name: ({n: _to_numpy(a) for n, a in leaf.items()} if name == "layers"
                   else _to_numpy(leaf)) for name, leaf in tree.items()}
