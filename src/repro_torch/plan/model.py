"""A small interpolating cost model over the probe grid — a copy of
``repro.plan.model`` (numpy only), kept here because the port imports
nothing of the JAX package.

Kernel costs are power laws to first order (dense match ~ k·c, sorted
merge-join ~ (k+c)·log k), so log-time is close to planar in (log k,
log c): the model stores the measured grid per (op, impl) and predicts by
bilinear interpolation of log2(time) over (log2 k, log2 c), clamping to
the grid edges. The tune CLI uses it to pick the plan's per-k impl table
and the chunk, and reports its predicted-vs-measured error on held-out
probe cells.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np


class CostModel:
    """log-log bilinear interpolator per (op, impl) over the probe grid."""

    def __init__(self, rows: Iterable[dict]):
        cells: dict = {}
        for r in rows:
            cells.setdefault((r["op"], r["impl"]), {})[
                (int(r["k"]), int(r["c"]))] = float(r["time_s"])
        self._grids = {}
        for key, pts in cells.items():
            ks = np.array(sorted({k for k, _ in pts}), dtype=np.float64)
            cs = np.array(sorted({c for _, c in pts}), dtype=np.float64)
            t = np.full((ks.size, cs.size), np.nan)
            for (k, c), v in pts.items():
                t[np.searchsorted(ks, k), np.searchsorted(cs, c)] = v
            if np.isnan(t).any():
                raise ValueError(
                    f"probe grid for {key} is not complete: every (k, c) "
                    f"combination must be measured")
            self._grids[key] = (np.log2(ks), np.log2(cs), np.log2(t))

    @property
    def keys(self):
        return tuple(sorted(self._grids))

    def impls_for(self, op: str):
        return tuple(sorted(i for o, i in self._grids if o == op))

    @staticmethod
    def _axis_weight(grid: np.ndarray, x: float):
        """Clamped bracketing (lo index, hi index, hi weight) on one axis."""
        x = min(max(x, grid[0]), grid[-1])
        hi = int(np.searchsorted(grid, x))
        if hi == 0:
            return 0, 0, 0.0
        lo = hi - 1
        if hi == grid.size:
            return lo, lo, 0.0
        span = grid[hi] - grid[lo]
        return lo, hi, float((x - grid[lo]) / span) if span else 0.0

    def predict(self, op: str, impl: str, k: int, c: int) -> float:
        """Predicted seconds for one dispatch of (op, impl) at (k, c)."""
        try:
            lk, lc, lt = self._grids[(op, impl)]
        except KeyError:
            raise KeyError(f"({op}, {impl}) was not probed; have "
                           f"{self.keys}") from None
        i0, i1, wi = self._axis_weight(lk, math.log2(max(k, 1)))
        j0, j1, wj = self._axis_weight(lc, math.log2(max(c, 1)))
        row0 = (1 - wj) * lt[i0, j0] + wj * lt[i0, j1]
        row1 = (1 - wj) * lt[i1, j0] + wj * lt[i1, j1]
        return float(2.0 ** ((1 - wi) * row0 + wi * row1))

    def choose_impl(self, op: str, k: int, c: int) -> str:
        """argmin impl for one dispatch (ties break lexicographically)."""
        impls = self.impls_for(op)
        if not impls:
            raise KeyError(f"op {op!r} was not probed")
        return min(impls, key=lambda i: (self.predict(op, i, k, c), i))

    def validate(self, rows: Iterable[dict]) -> list[dict]:
        """Relative |predicted − measured| / measured on held-out cells."""
        out = []
        for r in rows:
            pred = self.predict(r["op"], r["impl"], r["k"], r["c"])
            meas = float(r["time_s"])
            out.append({**r, "predicted_s": pred,
                        "rel_err": abs(pred - meas) / meas if meas else 0.0})
        return out
