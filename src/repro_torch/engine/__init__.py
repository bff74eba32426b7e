"""SketchEngine — batched multi-tenant sketching with deferred merges.

  * :class:`EngineConfig`  — geometry, flush mode, kernel and reduction.
  * :class:`SketchState`   — (B, k) summaries + a (B, T, C) pending buffer.
  * :class:`SketchEngine`  — update/flush/ingest/merge/query methods.
"""
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.engine import SketchEngine
from repro_torch.engine.reductions import (get_reduction, reduction_names,
                                           register_reduction)
from repro_torch.engine.state import (SketchState, flushed_summary, init_state,
                                      replayed_summary, state_from_numpy,
                                      state_to_numpy)

__all__ = [
    "EngineConfig", "SketchEngine", "SketchState", "flushed_summary",
    "init_state", "replayed_summary", "state_from_numpy", "state_to_numpy",
    "get_reduction", "reduction_names", "register_reduction",
]
