"""Trace — nested span context managers over a bounded JSON-lines ring.

The counterpart of ``repro.obs.trace``: the same ring, spans and event
schema.
The qualitative half of the obs layer (DESIGN.md §12): ``span("name")``
times a region, tracks nesting per thread, and appends one event dict to
a fixed-capacity ring when the region closes — O(1) memory no matter how
long the tier runs, oldest events evicted first. ``event()`` records
instant (zero-duration) marks; ``log()`` additionally renders the mark as
one structured ``[name] key=value`` line, which is how the serving CLIs
emit telemetry instead of ad-hoc ``print`` formatting.

Span events record completion order (a child closes before its parent),
with ``id``/``parent``/``depth`` carrying the nesting so consumers can
rebuild the tree; ``t`` is a ``time.perf_counter()`` timestamp, so
deltas — not absolute times — are meaningful within one process. Each
event additionally carries ``epoch`` (wall-clock ``time.time()``),
``pid`` and ``tid``, so exports from multiple tiers/processes can be
merged on a shared clock and correlated with flight-recorder dumps;
``export(since_event_id=...)`` tails the ring incrementally by the
monotone event id.

With ``annotate=True`` every span also enters a
``torch.profiler.record_function`` of the same name, so timelines captured
with ``torch.profiler`` (the card's kernels among them) carry the host-side
span names; outside a profiler it costs one small object per span.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time


def fmt_event(name: str, fields: dict) -> str:
    """One structured telemetry line: ``[name] key=value ...``."""
    parts = [f"[{name}]"]
    for k, v in fields.items():
        if isinstance(v, float):
            v = f"{v:.4g}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


class Tracer:
    """Per-scope span/event recorder with a bounded event ring."""

    def __init__(self, capacity: int = 4096, annotate: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self.capacity = capacity
        self.annotate = annotate

    # -- recording -----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a nested region; the event is ringed when it closes."""
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else 0
        depth = len(stack)
        ann = None
        if self.annotate:                   # profiler-timeline pass-through
            from torch.profiler import record_function
            ann = record_function(name)
            ann.__enter__()
        stack.append(sid)
        t0 = time.perf_counter()
        try:
            yield sid
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            if ann is not None:
                ann.__exit__(None, None, None)
            ev = {"kind": "span", "id": sid, "parent": parent,
                  "depth": depth, "name": name, "t": t0, "dur_s": dur,
                  "epoch": time.time() - dur, "pid": os.getpid(),
                  "tid": threading.get_ident(),
                  "thread": threading.current_thread().name}
            if attrs:
                ev["attrs"] = attrs
            self._append(ev)

    def event(self, name: str, **fields) -> dict:
        """Record one instant mark (parented to the active span)."""
        stack = self._stack()
        ev = {"kind": "event", "id": next(self._ids),
              "parent": stack[-1] if stack else 0, "depth": len(stack),
              "name": name, "t": time.perf_counter(),
              "epoch": time.time(), "pid": os.getpid(),
              "tid": threading.get_ident(),
              "thread": threading.current_thread().name}
        if fields:
            ev["attrs"] = fields
        self._append(ev)
        return ev

    def log(self, name: str, _printer=print, **fields) -> None:
        """``event()`` + one structured stdout line — the CLI surface."""
        self.event(name, **fields)
        _printer(fmt_event(name, fields))

    # -- reading -------------------------------------------------------------

    def events(self) -> list:
        """Ring contents, oldest first (a consistent copy)."""
        with self._lock:
            return list(self._events)

    def to_jsonl(self, last: int | None = None) -> str:
        """The (optionally tail-truncated) ring as JSON lines."""
        evs = self.events()
        if last is not None:
            evs = evs[-last:]
        return "\n".join(json.dumps(e) for e in evs)

    def export(self, since_event_id: int = 0,
               last: int | None = None) -> str:
        """JSON lines for events with ``id > since_event_id`` —
        incremental tailing: feed back the max id you've seen and only
        newer events come out (ids are monotone, so eviction from the
        ring can only drop events you would have skipped anyway)."""
        evs = [e for e in self.events() if e["id"] > since_event_id]
        if last is not None:
            evs = evs[-last:]
        return "\n".join(json.dumps(e) for e in evs)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return 0

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """No-op tracer for disabled scopes (shared, allocation-free)."""

    capacity = 0
    annotate = False

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def event(self, name: str, **fields) -> dict:
        return {}

    def log(self, name: str, _printer=print, **fields) -> None:
        _printer(fmt_event(name, fields))

    def events(self) -> list:
        return []

    def to_jsonl(self, last: int | None = None) -> str:
        return ""

    def export(self, since_event_id: int = 0,
               last: int | None = None) -> str:
        return ""

    def clear(self) -> None:
        pass


DEFAULT = Tracer()
NULL = _NullTracer()


def span(name: str, **attrs):
    """A span on the process-default tracer."""
    return DEFAULT.span(name, **attrs)


def event(name: str, **fields) -> dict:
    return DEFAULT.event(name, **fields)


def log(name: str, _printer=print, **fields) -> None:
    DEFAULT.log(name, _printer=_printer, **fields)
