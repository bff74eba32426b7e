"""Carry parameters between the JAX package's layout and the port's.

The one place where the two layouts meet. The JAX package keeps a layer
stack as one (L, ...) leaf per parameter under ``params["layers"]``, with
flat names (``attn_norm_scale``, ``wq``, ``wdkv``, ``router``, ``w_gate``,
``ssm_norm_scale``, ``in_proj``...); the port keeps one
:class:`~repro_torch.models.model.Block` (or ``MambaBlock``) per layer with
the same matrices, also (in, out), and the expert stacks (E, D, F) as they
are, so no leaf is transposed: each stacked leaf is split per layer and
renamed. ``w_gate``/``w_up``/``w_down`` name the MLP's matrices and the
MoE's expert stacks alike; they go to whichever module the block holds.
The hybrid family's ``shared_attn`` subtree is not stacked: its flat
names map to the port's ``shared_attn`` block one to one. The audio family
keeps two stacks, ``enc_layers`` (the port's ``encoder.layers``) and
``dec_layers`` (the port's ``layers``, whose ``cross_norm_*`` and
``cross_{wq,...,bv}`` leaves are the blocks' ``cross_norm`` and
``cross_attn``), and ``enc_final_norm_*`` (``encoder.final_norm``).
``bfloat16`` numpy arrays (``ml_dtypes``) travel as their 16-bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import check_family

# JAX flat layer name prefix -> the port's submodule ("cross_norm_" before
# "cross_", which names the cross attention's matrices and biases)
_LAYER_PREFIXES = (("attn_norm_", "attn_norm."), ("mlp_norm_", "mlp_norm."),
                   ("ssm_norm_", "ssm_norm."), ("cross_norm_", "cross_norm."),
                   ("cross_", "cross_attn."))
# JAX top-level norm prefix -> the port's norm module
_NORMS = {"enc_final_norm_": "encoder.final_norm.", "final_norm_": "final_norm."}
_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLA = ("wdq", "q_norm_scale", "wuq", "wdkv", "kv_norm_scale", "wuk", "wuv", "wo")
_MLP = ("w_gate", "w_up", "w_down", "b_up", "b_down")
_MOE = ("router", "w_gate", "w_up", "w_down")
_MAMBA = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm_scale",
          "out_proj")


def _layer_name(cfg, name: str, mamba: bool) -> str:
    """The port's name of a JAX layer leaf: of a ``MambaBlock`` when
    ``mamba``, else of a ``Block``."""
    for jax_prefix, port_prefix in _LAYER_PREFIXES:
        if name.startswith(jax_prefix):
            return port_prefix + name[len(jax_prefix):]
    if mamba:
        if name in _MAMBA:
            return "mixer." + name
    elif name in (_MLA if cfg.mla is not None else _ATTN):
        return "attn." + name
    elif name in (_MOE if cfg.moe is not None else _MLP):
        return ("moe." if cfg.moe is not None else "mlp.") + name
    raise KeyError(f"no port parameter for the JAX layer leaf {name!r}")


def _stacks(cfg) -> dict:
    """JAX layer stack -> the port's module list (a name prefix)."""
    if cfg.family == "audio":
        return {"enc_layers": "encoder.layers.", "dec_layers": "layers."}
    return {"layers": "layers."}


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
    mamba = cfg.family in ("ssm", "hybrid")
    stacks = _stacks(cfg)
    out = {}
    for name, leaf in tree.items():
        norm = next((n for n in _NORMS if name.startswith(n)), None)
        if name in stacks:
            for lname, stacked in leaf.items():
                port = _layer_name(cfg, lname, mamba)
                for i in range(stacked.shape[0]):
                    out[f"{stacks[name]}{i}.{port}"] = stacked[i]
        elif name == "shared_attn" and cfg.family == "hybrid":
            for lname, t in leaf.items():
                out["shared_attn." + _layer_name(cfg, lname, False)] = t
        elif norm is not None:
            out[_NORMS[norm] + name[len(norm):]] = leaf
        elif name in ("embed", "lm_head"):
            out[name] = leaf
        else:
            raise KeyError(f"no port parameter for the JAX leaf {name!r}")
    return out


_INVERSE_PREFIXES = {port: jax for jax, port in _LAYER_PREFIXES}


def jax_path(cfg, name: str) -> tuple:
    """Where the port's ``state_dict`` entry ``name`` lies in the JAX
    package's tree: ``(group, leaf, layer)``. ``group`` is the layer stack
    (``layers``, ``enc_layers``, ``dec_layers``), ``shared_attn`` or None
    (a top-level leaf); ``layer`` the index in the stack, else None."""
    def jax_name(port: str) -> str:      # "attn_norm.scale" -> "attn_norm_scale"
        head, _, tail = port.partition(".")
        return _INVERSE_PREFIXES.get(head + ".", "") + tail

    for stack, prefix in _stacks(cfg).items():
        if name.startswith(prefix):
            i, port = name[len(prefix):].split(".", 1)
            return stack, jax_name(port), int(i)
    if name.startswith("shared_attn."):
        return "shared_attn", jax_name(name[len("shared_attn."):]), None
    norm = next((jax for jax, port in _NORMS.items() if name.startswith(port)), None)
    if norm is not None:
        return None, norm + name.split(".")[-1], None
    return None, name, None


def stack_params(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`unstack_params`: tensors under the port's
    ``state_dict`` keys as the JAX package's tree, layers stacked
    (``torch.stack``, on the tensors' device; ``meta`` tensors stay
    ``meta``). The train checkpoints carry params, master weights and
    moments in this layout, so either package restores them."""
    check_family(cfg)
    tree: dict = {}
    per_layer: dict = {stack: {} for stack in _stacks(cfg)}
    for name, t in state_dict.items():
        group, leaf, i = jax_path(cfg, name)
        if i is not None:
            per_layer[group].setdefault(leaf, {})[i] = t
        elif group is not None:
            tree.setdefault(group, {})[leaf] = t
        else:
            tree[leaf] = t
    for stack, leaves in per_layer.items():
        tree[stack] = {name: torch.stack([by_layer[i] for i in range(len(by_layer))])
                       for name, by_layer in leaves.items()}
    return tree


def params_from_jax(cfg, tree: dict) -> dict:
    """The JAX package's ``init_params`` tree (numpy leaves) as the port's
    ``state_dict`` (CPU tensors, the leaves' dtypes)."""
    tree = {name: ({n: _to_torch(a) for n, a in leaf.items()} if isinstance(leaf, dict)
                   else _to_torch(leaf)) for name, leaf in tree.items()}
    return {name: t.clone() for name, t in unstack_params(cfg, tree).items()}


def params_to_jax(cfg, state_dict: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` as the JAX
    package's tree of numpy leaves, layers stacked on a leading dim."""
    tree = stack_params(cfg, {n: t.detach().cpu() for n, t in state_dict.items()})
    return {name: ({n: _to_numpy(a) for n, a in leaf.items()} if isinstance(leaf, dict)
                   else _to_numpy(leaf)) for name, leaf in tree.items()}
