"""Flight recorder — a bounded postmortem ring with one-file dumps.

The counterpart of ``repro.obs.recorder``, a copy whose strict-JSON
coercion also takes torch tensors (as their ``tolist()``).

The black box of the drift sentinel (DESIGN.md §14): every sampler tick
the recorder captures one *frame* — the full metrics surface, the
latest health and drift frames, and the set of firing alerts — into a
fixed-capacity ring. Memory is O(capacity) forever; at the default
64 frames × 0.25 s tick the ring holds the last ~16 s of tier history,
which is the window that actually matters when something dies.

A *dump* freezes the ring plus the trace-span tail and the alert
transition log into a single JSON artifact. Three triggers:

  * ``on_error`` — the :class:`~repro_torch.serve.ingest.IngestLoop` captured
    an exception (wired through ``ServeConfig``); the dump carries the
    traceback alongside the last frames, so the postmortem starts with
    *what the tier looked like while it was dying*, not just the stack.
  * ``on_alert`` — the first ``critical`` alert transition fires a dump
    (subsequent auto-triggers are suppressed: the first artifact is the
    interesting one, and a flapping alert must not spam the disk).
  * on demand — ``ServingTier.dump_flight_record()``.

Dumps are *strict* JSON: numpy scalars are unboxed and non-finite
floats become ``null`` (NaN is valid Python-json but not JSON), so any
consumer can parse the artifact — the CI obs-smoke leg gates exactly
that with :func:`validate_flight_record`.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
import traceback

import torch

SCHEMA = "repro.flight_record/v1"

# every dump must carry these; validate_flight_record enforces it
REQUIRED_KEYS = ("schema", "reason", "epoch", "pid", "frames", "spans",
                 "alerts", "metrics", "error")
FRAME_KEYS = ("t", "epoch", "metrics", "health", "drift",
              "alerts_active")


def _jsonable(obj):
    """Strict-JSON coercion: numpy scalars unboxed, tensors as lists,
    non-finite floats → None, mappings/sequences walked recursively."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, collections.deque)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            obj = obj.item()        # numpy scalar / 0-d array
        except Exception:
            return repr(obj)
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def validate_flight_record(record: dict) -> dict:
    """Raise ``ValueError`` unless ``record`` is a complete v1 dump;
    returns the record for chaining. This is the CI gate."""
    if not isinstance(record, dict):
        raise ValueError(f"flight record must be a dict, got "
                         f"{type(record).__name__}")
    missing = [k for k in REQUIRED_KEYS if k not in record]
    if missing:
        raise ValueError(f"flight record missing keys: {missing}")
    if record["schema"] != SCHEMA:
        raise ValueError(f"unknown flight record schema "
                         f"{record['schema']!r} (want {SCHEMA!r})")
    if not isinstance(record["frames"], list):
        raise ValueError("flight record frames must be a list")
    for i, frame in enumerate(record["frames"]):
        fmissing = [k for k in FRAME_KEYS if k not in frame]
        if fmissing:
            raise ValueError(
                f"flight record frame {i} missing keys: {fmissing}")
    return record


class FlightRecorder:
    """Continuous frame capture + triggered single-file JSON dumps.

    ``health_source`` / ``drift_source`` are zero-arg callables
    returning the latest frame dict or None (the monitor/estimator
    accessors); ``alerts`` is an :class:`~repro_torch.obs.alerts.AlertManager`
    or None. ``capture()`` is called from the sampler pump thread;
    ``dump()`` may be called from any thread (ingest-loop error
    handler, alert callback, user) — both are lock-guarded.
    """

    def __init__(self, registry, *, tracer=None, alerts=None,
                 health_source=None, drift_source=None,
                 capacity: int = 64, span_tail: int = 128,
                 path: str = "flight_record.json"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        from repro_torch.obs import trace as obs_trace
        self.registry = registry
        self.tracer = tracer if tracer is not None else obs_trace.NULL
        self.alerts = alerts
        self.health_source = health_source
        self.drift_source = drift_source
        self.capacity = int(capacity)
        self.span_tail = int(span_tail)
        self.path = path
        self._frames: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._auto_dumped = False
        self._captures = registry.counter("flight.captures")
        self._dumps = registry.counter("flight.dumps")
        self.last_dump_path: str | None = None

    # -- continuous capture --------------------------------------------------

    def capture(self, t: float | None = None) -> dict:
        """Append one frame to the postmortem ring (sampler-tick hook)."""
        t = time.perf_counter() if t is None else t
        frame = {
            "t": t,
            "epoch": time.time(),
            "metrics": self.registry.describe(),
            "health": (self.health_source()
                       if self.health_source is not None else None),
            "drift": (self.drift_source()
                      if self.drift_source is not None else None),
            "alerts_active": (self.alerts.active()
                              if self.alerts is not None else []),
        }
        with self._lock:
            self._frames.append(frame)
        self._captures.inc()
        return frame

    def frames(self) -> list:
        with self._lock:
            return list(self._frames)

    # -- triggered dumps -----------------------------------------------------

    def on_error(self, exc: BaseException) -> str | None:
        """IngestLoop error-capture trigger (auto, once)."""
        return self._auto_dump("ingest_error", error=exc)

    def on_alert(self, transition: dict) -> str | None:
        """Alert-fire trigger: dumps on the first critical alert."""
        if transition.get("severity") != "critical":
            return None
        return self._auto_dump(
            f"critical_alert:{transition.get('rule', '?')}")

    def _auto_dump(self, reason: str, error=None) -> str | None:
        with self._lock:
            if self._auto_dumped:
                return None
            self._auto_dumped = True
        return self.dump(reason=reason, error=error)

    def dump(self, reason: str = "on_demand", *, error=None,
             path: str | None = None) -> str:
        """Write the postmortem artifact; returns the path written."""
        record = self.build(reason=reason, error=error)
        path = path or self.path
        directory = os.path.dirname(path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, allow_nan=False)
        os.replace(tmp, path)       # readers never see a partial dump
        with self._lock:
            self.last_dump_path = path
        self._dumps.inc()
        self.tracer.event("flight.dump", reason=reason, path=path)
        return path

    def build(self, reason: str = "on_demand", error=None) -> dict:
        """The dump as a dict (strict-JSON-safe), without writing it."""
        err = None
        if error is not None:
            err = {"type": type(error).__name__, "message": str(error),
                   "traceback": "".join(traceback.format_exception(
                       type(error), error, error.__traceback__))}
        spans = self.tracer.events()[-self.span_tail:]
        record = {
            "schema": SCHEMA,
            "reason": reason,
            "epoch": time.time(),
            "pid": os.getpid(),
            "error": err,
            "frames": self.frames(),
            "spans": spans,
            "alerts": {
                "active": (self.alerts.active()
                           if self.alerts is not None else []),
                "transitions": (self.alerts.transitions()
                                if self.alerts is not None else []),
                "rules": (self.alerts.describe()
                          if self.alerts is not None else {}),
            },
            "metrics": self.registry.describe(),
            "health": (self.health_source()
                       if self.health_source is not None else None),
            "drift": (self.drift_source()
                      if self.drift_source is not None else None),
        }
        return _jsonable(record)
