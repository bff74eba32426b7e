"""Divisibility-driven sharding resolver (params + activations) over a
``torch.distributed`` DeviceMesh.

The counterpart of ``repro.sharding.rules``. Parameters carry logical axis
names (comma-joined strings, ``models/model.py:param_axes``). This module
maps logical names to mesh axes with greedy conflict/divisibility
resolution, producing:

  * ``ShardingPlan.param_specs(axes_tree, shapes_tree)`` -> a spec tree;
  * ``ShardingPlan.wsc(x, code)`` -> ``x`` redistributed to the activation
    spec of ``code`` ('bsd', 'bshd', ...) where the model code calls it;
  * :func:`placements` -> the DTensor placements of a spec on a mesh.

A spec is a tuple with one entry per tensor dim, each a mesh-axis name, a
tuple of names or None, as JAX's ``PartitionSpec`` holds it (1-tuples
normalised to the scalar). The specs are JAX's exactly; only the last step,
spec -> placements, is the port's.

Strategy (DESIGN.md §5):
  pod    — pure DP (params replicated across pods; optional FSDP extension)
  data   — FSDP for parameters ('embed' logical axis) + batch DP
  model  — TP: vocab, d_ff, flattened head dims, experts (EP mode), SSM inner
  decode — KV caches shard the *sequence* dim on 'model' (+ 'data' when the
           global batch cannot occupy the data axis, e.g. long_500k B=1)

Head-count dims that don't divide the axis (40/56/6 heads on 16) are sharded
unevenly: GSPMD pads internally, DTensor gives the first ranks one row more
(``torch.chunk``'s split); the full tensor is the same either way.

With ``mesh=None`` the plan is the single-process one: ``axis_sizes`` is
empty, ``batch_axes`` names the data axis (the token sketch has one group)
and ``wsc`` is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

# logical param axis -> ordered mesh-axis candidates (first fit wins).
# 'fsdp' is substituted with the plan's fsdp axes; None entries mean
# "replicate if nothing fits".
PARAM_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "vocab_rows": (),            # embed_rows_local: replicated rows
    "embed_tp": ("model",),      # embed_rows_local: TP columns
    "embed": ("fsdp",),
    "ff": ("model",),
    "expert_ff": ("model",),
    "attn_out": ("model",),
    "kv_out": ("model",),
    "lora": ("model",),
    "experts": (),            # filled per moe_strategy
    "router": (),
    "ssm_in": ("model",),
    "ssm_conv": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": (),
    "convk": (),
    "norm": (),
    "layers": (),
}

# assignment priority: dims earlier in this list grab mesh axes first.
PRIORITY = ["experts", "vocab", "expert_ff", "ff", "attn_out", "kv_out",
            "lora", "ssm_in", "ssm_conv", "ssm_inner", "embed"]


@dataclasses.dataclass(frozen=True)
class PlanOptions:
    moe_strategy: str = "tp"       # 'tp' (expert-internal TP) | 'ep'
    fsdp_over_pod: bool = False    # extend FSDP onto the pod axis
    seq_shard_cache: bool = True   # decode caches: shard seq dim on 'model'
    seq_sharded_residual: bool = False  # residual stream (B,S,D): S on 'model'
                                        # → per-layer AR becomes RS+AG (§Perf)
    no_tp: bool = False            # small models: pure DP, batch over 'model'


def _scalar(a):
    """("data",) -> "data": JAX's PartitionSpec treats them alike, and spec
    comparisons expect the scalar form."""
    return a[0] if isinstance(a, tuple) and len(a) == 1 else a


def _spec(*entries) -> tuple:
    """A spec of ``entries``, 1-tuples normalised as ``PartitionSpec`` does."""
    return tuple(_scalar(e) for e in entries)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.

    A tuple entry such as ``("pod", "data")`` puts ``Shard(d)`` on both mesh
    dims. DTensor splits a tensor dim that several mesh dims shard in
    mesh-dim order, the first mesh dim outermost. The resolver names the
    axes of a tuple entry in mesh order, major → minor, and JAX's
    ``PartitionSpec`` splits such an entry major → minor too, so both lay
    the same rows on the same device. A mesh axis may shard one tensor dim
    only: a spec that names it twice raises ``ValueError``, as JAX's
    ``NamedSharding`` raises ``DuplicateSpecError``.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(axis)
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} names mesh axis {axis!r} twice")
            out[i] = Shard(d)
    return out


class ShardingPlan:
    """Resolved sharding for one (arch × mesh × options).

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with named
    dims, or None. The JAX counterpart of each method is its namesake in
    ``repro.sharding.rules.ShardingPlan``: ``_axis_fits``, ``param_spec``,
    ``param_specs`` (specs, not NamedShardings: :func:`placements` turns a
    spec into DTensor placements), ``_batch``, ``act_spec``,
    ``_cache_seq_axes``, ``_ssm_spec``, ``wsc`` (a redistribute in place of
    ``with_sharding_constraint``) and ``batch_spec``. ``replicated`` is the
    port's own: the context in which a step runs on DTensors.
    """

    def __init__(self, cfg, mesh=None, opts: PlanOptions = PlanOptions()):
        self.cfg = cfg
        self.mesh = mesh
        self.opts = opts
        if mesh is not None:
            self.axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        else:
            self.axis_sizes = {}
        self.has_pod = "pod" in self.axis_sizes
        fsdp = ("pod", "data") if (opts.fsdp_over_pod and self.has_pod) \
            else ("data",)
        self.fsdp_axes = fsdp
        self.batch_axes = ("pod", "data") if self.has_pod else ("data",)
        rules = dict(PARAM_RULES)
        if cfg.moe is not None and opts.moe_strategy == "ep":
            rules["experts"] = ("model",)
            rules["expert_ff"] = ()
        if opts.no_tp:
            # pure data parallelism: the model axis joins the batch axes,
            # every 'model' rule drops to replicate (small-model regime).
            rules = {k: tuple(c for c in v if c != "model")
                     for k, v in rules.items()}
            self.batch_axes = self.batch_axes + ("model",)
        self.rules = rules

    # -- parameters --------------------------------------------------------

    def _axis_fits(self, axis, dim: int, used: set) -> bool:
        if axis in used:
            return False
        size = math.prod(self.axis_sizes.get(a, 1)
                         for a in (axis if isinstance(axis, tuple) else (axis,)))
        return dim % size == 0

    def param_spec(self, axes_str: str, shape: tuple) -> tuple:
        if not self.axis_sizes:
            return ()
        names = axes_str.split(",")
        assert len(names) == len(shape), (axes_str, shape)
        assign: dict[int, object] = {}
        used: set = set()
        order = sorted(range(len(names)),
                       key=lambda i: PRIORITY.index(names[i])
                       if names[i] in PRIORITY else len(PRIORITY))
        for i in order:
            cands = self.rules.get(names[i], ())
            for cand in cands:
                cand = self.fsdp_axes if cand == "fsdp" else cand
                flat = cand if isinstance(cand, tuple) else (cand,)
                if all(f not in used for f in flat) and \
                        self._axis_fits(cand, shape[i], used):
                    assign[i] = cand
                    used.update(flat)
                    break
        return _spec(*(assign.get(i) for i in range(len(names))))

    def param_specs(self, axes_tree: dict, shapes_tree: dict) -> dict:
        """The spec of every leaf of ``axes_tree`` (nested dicts of axes
        strings) at its shape in ``shapes_tree`` (the same keys; tensors)."""
        return {name: (self.param_specs(axes, shapes_tree[name]) if isinstance(axes, dict)
                       else self.param_spec(axes, tuple(shapes_tree[name].shape)))
                for name, axes in axes_tree.items()}

    # -- activations -------------------------------------------------------

    def _batch(self, b: int):
        """Largest prefix of batch axes whose product divides b."""
        axes = []
        prod = 1
        for a in self.batch_axes:
            size = self.axis_sizes.get(a, 1)
            if b % (prod * size) == 0:
                axes.append(a)
                prod *= size
        return tuple(axes) if axes else None

    def act_spec(self, code: str, shape: tuple) -> tuple:
        m = self.axis_sizes.get("model", 1)
        bt = self._batch(shape[0])
        ep = self.cfg.moe is not None and self.opts.moe_strategy == "ep"
        if code == "bsd":        # (B,S,D) residual stream
            if self.opts.seq_sharded_residual and not self.opts.no_tp \
                    and shape[1] % max(m, 1) == 0:
                return _spec(bt, "model", None)       # sequence-parallel sections
            return _spec(bt, None, None)
        if code == "bsx":        # (B,S,X) inside a section: whole but for the batch
            return _spec(bt, None, None)
        if code == "bsv":        # (B,S,V) logits — vocab TP
            if self.opts.no_tp:
                return _spec(bt, None, None)
            return _spec(bt, None, "model")
        if code == "bshd":       # (B,S,H,hd) flat-head q/out — heads TP (maybe uneven)
            if self.opts.no_tp:
                return _spec(bt, None, None, None)
            return _spec(bt, None, "model", None)
        if code == "bskvh":      # (B,S,KV,hd) prefill k/v — replicated over model
            return _spec(bt, None, None, None)
        if code == "btf":        # (B,S,F) mlp hidden — ff TP
            return _spec(bt, None, None if self.opts.no_tp else "model")
        if code == "becd":       # (B,E,C,D) moe dispatch buffer
            edim = "model" if ep and not self.opts.no_tp \
                and self.cfg.moe.n_experts % m == 0 else None
            return _spec(bt, edim, None, None)
        if code == "becf":       # (B,E,C,F) moe expert hidden
            if self.opts.no_tp:
                return _spec(bt, None, None, None)
            if ep and self.cfg.moe.n_experts % m == 0:
                return _spec(bt, "model", None, None)
            return _spec(bt, None, None, "model")
        if code == "blhp":       # (B,L,H,P) ssm head-split activations
            return self._ssm_spec(shape, bt)
        if code == "bskh":       # (B,S,KV,hd) decode KV cache — sequence-parallel
            return _spec(bt, self._cache_seq_axes(shape), None, None)
        raise KeyError(code)

    def _cache_seq_axes(self, shape, seq_dim: int | None = None):
        if not self.opts.seq_shard_cache:
            return None
        b = shape[0]
        used = self._batch(b) or ()
        axes = [a for a in ("data", "model")
                if a not in used and a in self.axis_sizes]
        if "model" in axes and b >= self.axis_sizes.get("data", 1) \
                and "data" in axes:
            axes.remove("data")   # plenty of batch: seq on model only
        if seq_dim is not None:
            # keep the longest suffix-compatible prefix that divides seq_dim
            while axes:
                prod = 1
                for a in axes:
                    prod *= self.axis_sizes.get(a, 1)
                if seq_dim % prod == 0:
                    break
                axes.pop(0)
        if not axes:
            return None
        return tuple(axes)

    def _ssm_spec(self, shape, bt):
        m = self.axis_sizes.get("model", 1)
        if self.opts.no_tp:
            return _spec(bt, None, None, None)
        h, p_dim = shape[2], shape[3]
        if h % m == 0:
            return _spec(bt, None, "model", None)
        if p_dim % m == 0:
            return _spec(bt, None, None, "model")
        return _spec(bt, None, None, None)

    def wsc(self, x, code: str):
        """``x`` redistributed to ``act_spec(code, x.shape)`` when it is a
        DTensor (which it is only on a plan with a mesh), else ``x``."""
        from torch.distributed.tensor import DTensor
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(self.act_spec(code, x.shape), self.mesh))

    def replicated(self):
        """The context a step runs in: on a mesh, DTensor's
        ``implicit_replication``, under which a plain tensor the model makes
        from shapes (RoPE tables, masks, softmax carries, positions, a
        decode position) meets the DTensors as a replicated DTensor of the
        plan's mesh; without a mesh, a context that does nothing, so the
        unsharded path runs exactly its own code."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    # -- inputs / steps -----------------------------------------------------

    def batch_spec(self, b: int) -> tuple:
        return _spec(self._batch(b), None)

    # sketch-state shardings live with the engine adapter:
    # repro_torch.train.sketch.sketch_shardings.


def null_plan(cfg) -> ShardingPlan:
    return ShardingPlan(cfg, None)
