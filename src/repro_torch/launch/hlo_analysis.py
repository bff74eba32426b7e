"""Roofline terms of one step, read from the ops it dispatches.

The counterpart of ``repro.launch.hlo_analysis``, which parses the
compiled, partitioned HLO text. Eager torch has no HLO: :func:`analyze`
runs the step once under dispatch modes and counts what one rank does,
op by op. An eager Python loop (over layers, over the SSD's chunks, the
attention tile loop under autograd or on real tensors) dispatches every
iteration's ops and is counted every iteration. A loop declared uniform
(:func:`uniform_loop`: its iterations run the same ops on the same
shapes) is counted as JAX's analysis counts a ``while`` body, once times
its trip count, when the step runs on fake tensors with no autograd
graph: one loop is so declared, ``models/attention.py:
blockwise_attention``'s over its (q, kv) tiles, JAX's ``lax.scan``
(the dry run's 32k prefills, 2 080–4 096 tiles a layer). A
``torch.utils.checkpoint`` recompute dispatches its ops again and is
counted again, as XLA counts a remat.

  flops — 2·|out|·K for every matmul, bmm and einsum product, and the
          equivalent for every convolution (``torch.utils.flop_counter``'s
          formulas), on each rank's local tensors: a DTensor op is let
          through to the local ops DTensor issues for it, so a product
          whose contraction is sharded counts 2·|local out|·K_local and a
          replicated one counts whole on every rank. Elementwise FLOPs are
          excluded, as in the JAX package: the compute term is tensor-core
          work; the rest is in the memory term.
  bytes — operand + result bytes of every dispatched op that returns a
          tensor, on local tensors; views, allocations without a write
          and collective waits are free. XLA's unfused bytes-accessed
          convention, and in eager torch every op does touch memory.
  wire  — collective bytes × ring factors (below), g read from the
          collective's own process group.

The ops DTensor's sharding propagation runs under a fake mode of its own,
to infer shapes, are not work and are not counted.

Wire-byte convention (ring algorithms), as the JAX package's:
  all-gather: (g-1)/g · out;  all-reduce: 2·(g-1)/g · out;
  reduce-scatter: (g-1) · out;  all-to-all: (g-1)/g · out;
  collective-permute: out.

What XLA's analysis gives that this one does not: bytes after fusion (a
fused elementwise chain touches memory once in XLA, once an op here), and
its slicing rules (a fusion that reads a buffer only through a slice is
charged the slice, ``hlo_analysis.py:167-234``); here a slice is a view and
the op that reads it is charged what it reads, which comes to the same.

Memory of a step (JAX's ``memory_analysis`` fields): the local bytes of
the arguments and of the outputs, the peak of the temporaries (the most
the storages the step made held at once, less what is still held at its
end: the outputs it made) and the bytes of argument storages the step
wrote in place (``alias_bytes``, JAX's donated buffers). The storages are
followed by :class:`StepCounter` itself (a weak reference each, as
``torch.distributed._tools.mem_tracker.MemTracker`` follows them):
``MemTracker`` registers a gradient hook on every parameter of a module
it sees run, which raises for a serving step, whose parameters take no
gradient.
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

# H100 SXM5 ("NVIDIA H100 80GB HBM3"), NVIDIA's data sheet: dense rates
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores, no sparsity
HBM_BW = 3.35e12               # B/s
LINK_BW = 450e9                # B/s a direction: NVLink 4, 900 GB/s both ways

# ops that move no bytes of their own: allocations without a write and the
# functional collectives' waits and autograd wrappers (aliases)
_FREE = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
         "aten.new_empty_strided", "aten.lift_fresh", "_c10d_functional.wait_tensor",
         "c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd"}

# collective op name -> JAX's kind; anything else a collective is counted
# as a permute (its output once on the wire)
_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_gather", "all-gather"),
          ("allgather", "all-gather"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))


def _fake_mode_active() -> bool:
    """True inside a FakeTensorMode: DTensor's shape inference, not work."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def tensor_leaves(tree) -> list:
    """The tensors of ``tree`` (dicts, tuples, NamedTuples, lists; a module
    stands for its parameters and buffers), a DTensor as its local shard."""
    out = []
    for leaf in _pytree.tree_leaves(tree):
        if isinstance(leaf, nn.Module):
            out += tensor_leaves([*leaf.parameters(), *leaf.buffers()])
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf._local_tensor if isinstance(leaf, DTensor) else leaf)
    return out


def tree_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (:func:`tensor_leaves`: one rank's
    shards), each storage once."""
    seen, total = set(), 0
    for t in tensor_leaves(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += t.numel() * t.element_size()
    return total


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (a group
    name, or the group itself); 2, as the JAX package's default, if none."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    return 2


def _kind(name: str) -> str:
    return next((kind for key, kind in _KINDS if key in name), "collective-permute")


def wire_bytes(kind: str, g: int, out_bytes: float) -> float:
    """Bytes one rank puts on the wire for a collective of ``kind`` over
    ``g`` ranks whose output is ``out_bytes`` (ring algorithms)."""
    ring = (g - 1) / g
    if kind == "all-reduce":
        return 2 * ring * out_bytes
    if kind == "reduce-scatter":
        return (g - 1) * out_bytes
    if kind in ("all-gather", "all-to-all"):
        return ring * out_bytes
    return out_bytes


def _op_flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    f = flop_registry.get(func._overloadpacket)
    return int(f(*args, **kwargs, out_val=out)) if f is not None else 0


def _op_bytes(func, args, kwargs, out) -> int:
    """Operand + result bytes of one op; 0 for a view, an op that returns
    no tensor and the free ops."""
    outs = [t for t in _pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
    if not outs or func.is_view or str(func._overloadpacket) in _FREE:
        return 0
    ins = [t for t in _pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in ins + outs)


class _Counts:
    """FLOPs and bytes as a counter holds them, which :func:`uniform_loop`
    marks before a loop's first iteration and repeats after it."""

    def _mark(self):
        return self.flops, self.bytes_accessed

    def _repeat(self, mark, times: int) -> None:
        """Add what was counted since ``mark`` ``times`` more times."""
        flops, nbytes = mark[:2]
        self.flops += (self.flops - flops) * times
        self.bytes_accessed += (self.bytes_accessed - nbytes) * times


class StepCounter(_Counts, TorchDispatchMode):
    """A dispatch mode that counts, on each rank's local tensors, the FLOPs
    and bytes of every op (module docstring), every collective by JAX's
    kind (``count``, output ``bytes``, ``wire_bytes``) and by op as
    ``CommDebugMode`` names it (``get_comm_counts()``), the bytes each rank
    hands each collective op (``handed``, by op) with every call in
    ``calls``, and the bytes of the storages its ops made that are alive
    (``live``) and their most at once (``peak``). ``known``: the storages
    the step was handed, which are not new; those of them an op writes in
    place are kept in ``written`` (id -> bytes).

    It counts the collectives ``CommDebugMode`` counts, without its module
    tracker, which pops its stack once too often when a module runs twice
    in one context (zamba2's shared attention block)."""

    supports_higher_order_operators = True

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self._known = {id(st): st.nbytes() for st in known}
        self._made = set(self._known)
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
        self.comm_counts = collections.Counter()
        self.handed = collections.Counter()
        self.calls = []
        self.written = {}

    def get_comm_counts(self) -> dict:
        return dict(self.comm_counts)

    def _mark(self):
        return (*super()._mark(), {k: dict(v) for k, v in self.collectives.items()},
                collections.Counter(self.comm_counts), collections.Counter(self.handed),
                len(self.calls))

    def _repeat(self, mark, times: int) -> None:
        super()._repeat(mark, times)
        colls, comm, handed, n_calls = mark[2:]
        for kind, c in self.collectives.items():
            for key in c:
                c[key] += (c[key] - colls.get(kind, {}).get(key, 0)) * times
        for now, then in ((self.comm_counts, comm), (self.handed, handed)):
            for key in list(now):
                now[key] += (now[key] - then[key]) * times
        self.calls += self.calls[n_calls:] * times

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor issue its local ops (and collectives), which come
            # back here: one rank's work
            return NotImplemented
        shape_inference = _fake_mode_active()
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet is None or shape_inference:
            return out
        self.flops += _op_flops(func, args, kwargs, out)
        self.bytes_accessed += _op_bytes(func, args, kwargs, out)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write and i < len(args) \
                    and isinstance(args[i], torch.Tensor):
                key = id(args[i].untyped_storage())
                if key in self._known:
                    self.written[key] = self._known[key]
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._follow(t.untyped_storage())
        names, comm_ops = _comm_ops()
        if packet in comm_ops:
            self.comm_counts[names.get(packet, packet)] += 1
            n = sum(t.numel() * t.element_size()
                    for t in _pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
            self.handed[str(packet)] += n
            self.calls.append((str(packet), n))
            kind = _kind(str(packet))
            out_b = sum(t.numel() * t.element_size()
                        for t in _pytree.tree_leaves(out) if isinstance(t, torch.Tensor))
            c = self.collectives[kind]
            c["count"] += 1
            c["bytes"] += out_b
            c["wire_bytes"] += wire_bytes(kind, _group_size(args), out_b)
        return out

    def _follow(self, st) -> None:
        key = id(st)
        if key in self._made:
            return
        self._made.add(key)
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key, st.nbytes())

    def _freed(self, key, n) -> None:
        self._made.discard(key)
        self.live -= n


@functools.cache
def _comm_ops():
    """(the functional collectives' legacy names by native op, every
    collective op ``CommDebugMode`` counts)."""
    from torch.distributed.tensor.debug._comm_mode import (NATIVE_TO_PY_MAPPING,
                                                           c10d_collective_ops)
    ops = {*NATIVE_TO_PY_MAPPING, *NATIVE_TO_PY_MAPPING.values(),
           torch.ops._dtensor.shard_dim_alltoall, *c10d_collective_ops}
    return NATIVE_TO_PY_MAPPING, ops


class _GlobalCounter(_Counts, TorchDispatchMode):
    """FLOPs and bytes of the ops as they are called: a DTensor op at its
    global shapes, once (the raw count, ``xla_cost_raw``'s place)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.HigherOrderOperator):
            self.flops += _op_flops(func, args, kwargs, out)
            self.bytes_accessed += _op_bytes(func, args, kwargs, out)
        return out


def uniform_loop(trips: list, *tensors):
    """Iterate ``trips``, the trips of a loop whose every iteration runs the
    same ops on tensors of the same shapes (JAX's ``lax.scan``, which its
    analysis counts once, times its ``known_trip_count``). While a step is
    counted on fake ``tensors`` (a FakeTensor each: shapes, no values) and
    no autograd graph is recorded, only the first trip runs, and every
    counter of this module that is active adds what that trip counted
    ``len(trips) - 1`` more times. The peak of the temporaries is not
    scaled: an iteration must free its own before the next, so that one
    trip peaks as every trip does. Anywhere else every trip runs."""
    from torch._subclasses.fake_tensor import FakeTensor
    counters = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, _Counts)]
    if len(trips) < 2 or not counters \
            or not all(isinstance(t, FakeTensor) for t in tensors) \
            or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        yield from trips
        return
    marks = [c._mark() for c in counters]
    yield trips[0]
    for c, mark in zip(counters, marks):
        c._repeat(mark, len(trips) - 1)


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count one rank's work.

    Returns JAX's ``analyze`` keys, ``flops`` and ``bytes`` a device and
    ``collectives`` by kind, and ``memory`` (``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``alias_bytes``) and ``global``
    (``flops`` and ``bytes`` of the ops at their global shapes).
    """
    known = [t.untyped_storage() for t in tensor_leaves((args, kwargs))]
    with StepCounter(known) as local, _GlobalCounter() as whole:
        out = fn(*args, **kwargs)
    return {
        "flops": float(local.flops), "bytes": float(local.bytes_accessed),
        "collectives": {k: dict(v) for k, v in local.collectives.items()},
        "memory": {"argument_bytes": tree_bytes((args, kwargs)),
                   "output_bytes": tree_bytes(out),
                   "temp_bytes": local.peak - local.live,
                   "alias_bytes": sum(local.written.values())},
        "global": {"flops": float(whole.flops), "bytes": float(whole.bytes_accessed)},
    }


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float) -> dict:
    """The three times a step cannot beat on one H100, its bottleneck and
    its lower bound, keyed as the JAX package's."""
    t_compute = flops_per_device / PEAK_FLOPS_BF16
    t_memory = bytes_per_device / HBM_BW
    t_collective = wire_bytes_per_device / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_collective}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    terms["step_lower_bound_s"] = max(t_compute, t_memory, t_collective)
    return terms
