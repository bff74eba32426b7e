"""The harness's spans and the reading of the profiler's trace.

The harness wraps its own calls into each layer of the port in
``record_function`` spans named ``sketchbench.<layer>``. In a ``--trace 1``
run ``torch.profiler`` records a sub-window of whole epochs; the trace is
exported as Chrome JSON into a temporary directory (under ``$TMPDIR``),
read back and deleted. From it:

  * each harness span's host interval;
  * each device operation (kernel, copy, set) with its device interval,
    tied to the host launch by its correlation id, so that an operation
    belongs to the span in which the host launched it;
  * the union of the device intervals (busy time) over the sub-window, the
    longest idle gaps labelled by what the host was inside at the gap's
    start, and the device operations that took most time.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

PREFIX = "sketchbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_TAIL = re.compile(r"\(.*$")


@contextlib.contextmanager
def span(name: str, on: bool):
    """A harness span ``sketchbench.<name>`` (a no-op with ``on`` false)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = _NAME_TAIL.sub("", name.replace("(anonymous namespace)::", ""))
    return name[5:] if name.startswith("void ") else name


class Recorder:
    """A profiler over CPU and CUDA activity, started and stopped by hand."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self):
        self._prof.start()

    def stop(self) -> "Trace":
        self._prof.stop()
        with tempfile.TemporaryDirectory(prefix="sketchbench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return Trace(events)


class Trace:
    """Spans and device operations of one recorded sub-window."""

    def __init__(self, events):
        self.spans = []       # (start_us, end_us, name) of the harness's spans
        self.host = []        # (start_us, end_us, name) of every host op
        launches = {}         # correlation id -> host launch time (us)
        self.ops = []         # (start_us, end_us, short name, host launch us | None)
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if cat in DEVICE_CATS:
                device.append((t0, t1, name, (e.get("args") or {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches.setdefault(corr, t0)
            elif cat == "user_annotation" and name.startswith(PREFIX):
                self.spans.append((t0, t1, name[len(PREFIX):]))
            elif cat == "cpu_op":
                self.host.append((t0, t1, name))
        self.unlaunched = 0
        for t0, t1, name, corr in device:
            at = launches.get(corr)
            self.unlaunched += at is None
            self.ops.append((t0, t1, short_name(name), at))
        self.ops.sort()
        self.spans.sort()
        self.host.sort()

    # -- spans ---------------------------------------------------------------

    def span_intervals(self, name: str):
        return [(a, b) for a, b, n in self.spans if n == name]

    def span_host_s(self, name: str) -> float:
        return sum(b - a for a, b in self.span_intervals(name)) / 1e6

    def span_count(self, name: str) -> int:
        return len(self.span_intervals(name))

    def span_device_s(self, name: str) -> float | None:
        """Device time of the operations launched inside spans ``name``
        (an operation with no launch record counts where it started)."""
        iv = self.span_intervals(name)
        if not iv:
            return None
        starts = [a for a, _ in iv]
        total = 0.0
        for t0, t1, _, at in self.ops:
            t = t0 if at is None else at
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += t1 - t0
        return total / 1e6

    # -- the device over the sub-window --------------------------------------

    def window(self):
        """(start, end) in us: the first span's start to the last span's end."""
        if not self.spans:
            return None
        return self.spans[0][0], max(b for _, b, _ in self.spans)

    def busy_intervals(self):
        w = self.window()
        if w is None:
            return []
        merged = []
        for t0, t1, _, _ in self.ops:
            t0, t1 = max(t0, w[0]), min(t1, w[1])
            if t1 <= t0:
                continue
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    def window_s(self) -> float | None:
        w = self.window()
        return None if w is None else (w[1] - w[0]) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def _host_at(self, t: float) -> str:
        """The harness span and the innermost host op the host was in at t."""
        inner = ""
        for a, b, n in self.spans:
            if a <= t <= b:
                inner = n
        op = ""
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        while i >= 0:
            a, b, n = self.host[i]
            if a <= t <= b:
                op = n
                break
            if t - a > 5e5:          # no op that began 0.5 s earlier is open
                break
            i -= 1
        return f"{inner or 'outside spans'} > {op}" if op else (inner or "outside spans")

    def breakdown(self, n: int = 10) -> dict:
        """The device ops that took most time, and the longest idle gaps by
        what the host was doing when each began."""
        w = self.window()
        by_name = {}
        for t0, t1, name, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = []
        busy = self.busy_intervals()
        edges = ([w[0]] + [x for iv in busy for x in iv] + [w[1]]) if w else []
        for i in range(0, len(edges) - 1, 2):
            a, b = edges[i], edges[i + 1]
            if b > a:
                gaps.append((b - a, a))
        gaps.sort(reverse=True)
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self._host_at(a), d / 1e6] for d, a in gaps[:n]]}
