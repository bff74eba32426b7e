"""EngineConfig — one place for every sketching policy knob.

The counterpart of ``repro.engine.config``, with the same geometry
defaults (k = 2048 counters, chunk C = 2048, buffer depth T = 8) plus the
``device`` the engine's state lives on, the card unless the caller asks for
the CPU. An explicit ``kernel`` pins every match, COMBINE and query the
engine makes. ``kernel="auto"`` resolves through the plan of the engine's
device (``repro_torch.plan``): its ``"combine"`` table governs matches,
COMBINEs and queries (:meth:`resolved_kernel`) and its ``"flush"`` table
the deferred flush (:meth:`resolved_flush_kernel`), so a measured plan may
route the flush and the COMBINE tree to the fused kernels, as JAX's does.
With ``'fused'`` the deferred flush (``window_fn``) and every round of the
COMBINE tree (``pair_fn``) are one ``ss_ingest`` launch each, while
matches and queries outside them take ``'sorted'``, the kernels' own
matcher.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

FLUSH_MODES = ("deferred", "replay")
COUNT_DTYPES = ("int32", "int64")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of one :class:`~repro_torch.engine.engine.SketchEngine`."""

    k: int = 2048                  # counters per tenant summary
    tenants: int = 1               # B — concurrent sketches
    chunk: int = 2048              # C — stream elements per buffered chunk
    buffer_depth: int = 8          # T — chunks buffered between merges
    flush_mode: str = "deferred"   # 'deferred' | 'replay'
    reduction: str = "local"       # key into the reduction registry
    kernel: str = "auto"           # 'auto' | 'torch' | 'sorted' | 'cuda' | 'fused'
    count_dtype: str = "int32"     # 'int32' | 'int64'
    device: str = "cuda"           # where the state lives and kernels run
    axis_names: tuple = ()         # mesh dimensions the reduction spans beyond
                                   # the tenants, innermost first; their process
                                   # groups come with the engine's mesh

    def __post_init__(self):
        if self.k <= 0 or self.tenants <= 0 or self.chunk <= 0:
            raise ValueError(f"k/tenants/chunk must be positive: {self}")
        if self.buffer_depth <= 0:
            raise ValueError(f"buffer_depth must be >= 1, got {self.buffer_depth}")
        if self.flush_mode not in FLUSH_MODES:
            raise ValueError(f"flush_mode {self.flush_mode!r} not in {FLUSH_MODES}")
        if self.count_dtype not in COUNT_DTYPES:
            raise ValueError(f"count_dtype {self.count_dtype!r} not in {COUNT_DTYPES}")
        from repro_torch.engine.reductions import reduction_names
        if self.reduction not in reduction_names():
            raise ValueError(f"reduction {self.reduction!r} not registered; "
                             f"have {sorted(reduction_names())}")
        if not isinstance(self.axis_names, tuple):
            raise ValueError(f"axis_names must be a tuple, got {self.axis_names!r}")
        from repro_torch.kernels.ops import IMPLS
        if self.kernel not in IMPLS:
            raise ValueError(f"kernel {self.kernel!r} not in {IMPLS}")
        if self.kernel == "cuda" and torch.device(self.device).type != "cuda":
            raise ValueError(f"kernel='cuda' needs a CUDA device, got {self.device!r}")

    # -- resolved properties ------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.count_dtype)

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def resolved_kernel(self) -> str:
        """The impl of every match, COMBINE and query this engine makes.

        An explicit ``kernel=`` pins it; ``'auto'`` resolves through the
        plan's ``"combine"`` table for this engine's device (every impl
        returns the same bits, so this is a speed decision).
        """
        if self.kernel != "auto":
            return self.kernel
        from repro_torch.kernels.ops import resolve_impl
        return resolve_impl("combine", self.k, self.device)

    def resolved_flush_kernel(self) -> str:
        """The impl of the window-level flush (``ops.ingest_window``).

        An explicit ``kernel=`` pins it; ``'auto'`` resolves through the
        plan's ``"flush"`` table, which routes to ``'fused'`` only where a
        measurement put it (the static rule never does), as JAX's
        ``EngineConfig.resolved_flush_kernel``: the fused kernels take every
        k and window.
        """
        if self.kernel != "auto":
            return self.kernel
        from repro_torch.kernels.ops import resolve_impl
        return resolve_impl("flush", self.k, self.device)

    def window_fn(self):
        """The ``(summary (B, k), window (B, W)) -> Summary`` flush of every
        deferred merge: ``ops.ingest_window`` under the resolved flush impl
        (one ``ss_ingest`` launch when it is ``'fused'``). Same bits for
        every impl."""
        from repro_torch.core.spacesaving import Summary
        from repro_torch.kernels import ops as kops
        ingest = functools.partial(kops.ingest_window, impl=self.resolved_flush_kernel())

        def window_fn(summary, window):
            return Summary(*ingest(summary.items, summary.counts, summary.errors, window))
        return window_fn

    def pair_fn(self):
        """Batched pairwise COMBINE for the reduction tree, or None.

        Non-None only when the flush resolves to ``'fused'``: then every
        tree round is one ``ss_ingest`` COMBINE launch over its (half, k)
        pairs instead of the library ``combine`` (same bits).
        """
        if self.resolved_flush_kernel() != "fused":
            return None
        from repro_torch.core.spacesaving import Summary
        from repro_torch.kernels import ops as kops

        def pair_fn(s1, s2):
            return Summary(*kops.combine_summaries(*s1, *s2, impl="fused"))
        return pair_fn

    def match_fn(self):
        """The combine-match every merge in this engine uses (``'fused'``
        degrades to ``'sorted'`` there, in ``ops``)."""
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.combine_match, impl=self.resolved_kernel())

    def query_fn(self):
        """The query kernel every estimate in this engine uses (``'fused'``
        degrades to ``'sorted'``)."""
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.query, impl=self.resolved_kernel())
