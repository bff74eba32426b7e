"""EngineConfig — one place for every sketching policy knob.

The counterpart of ``repro.engine.config``, with the same geometry
defaults (k = 2048 counters, chunk C = 2048, buffer depth T = 8) plus the
``device`` the engine's state lives on, the card unless the caller asks for
the CPU. ``kernel`` is resolved once here, by the static rule of
``kernels.ops.resolve_impl`` (the port has no measured plan yet), and
threaded to every match, COMBINE and query the engine makes.
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
    kernel: str = "auto"           # 'auto' | 'torch' | 'sorted' | 'cuda'
    count_dtype: str = "int32"     # 'int32' | 'int64'
    device: str = "cuda"           # where the state lives and kernels run

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
        if (self.resolved_kernel() == "cuda"
                and torch.device(self.device).type != "cuda"):
            raise ValueError(f"kernel='cuda' needs a CUDA device, got {self.device!r}")

    # -- resolved properties ------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.count_dtype)

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def resolved_kernel(self) -> str:
        """Collapse 'auto' to a concrete impl for this engine's device.

        One impl governs every match, COMBINE and query the engine makes
        (every impl returns the same bits, so this is a speed decision).
        """
        from repro_torch.kernels.ops import resolve_impl
        return resolve_impl(self.kernel, self.k, self.device)

    def match_fn(self):
        """The combine-match every merge in this engine uses."""
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.combine_match, impl=self.resolved_kernel())

    def query_fn(self):
        """The query kernel every estimate in this engine uses."""
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.query, impl=self.resolved_kernel())
