"""Tumbling epochs through ``StreamRuntime``: ingest, snapshot, report.

Set-up: the configuration's kernel plan is installed in the process
(``repro_torch.plan.use_plan``, under the card's fingerprint; nothing is
tuned or written), the runtime and its ``QueryFrontend`` are built, the
mix's pool is drawn on the device from the seed, and one whole epoch runs
untimed, which builds and warms every kernel and shape the window uses.

An epoch, timed as a user runs it:

  1. ``StreamRuntime.init()``;
  2. ``StreamRuntime.ingest(state, block)`` for each block of the epoch,
     device-resident slices of the pool;
  3. ``StreamRuntime.snapshot(state)``;
  4. ``QueryFrontend.k_majority_report(snap, k')`` and
     ``QueryFrontend.top(snap, n)``, copied to the host.

Epochs run back to back until ``seconds`` have passed; the window closes
once the last epoch's report is on the host. An epoch's report latency
runs from just before the host hands over its last block to its report
being on the host, and so includes whatever work was still queued on the
device. With ``trace`` the profiler starts at the first epoch that begins
after ``TRACE_START`` of the window and records it without spans (its
start-up cost lands there) and then ``TRACE_EPOCHS`` whole epochs, the
traced sub-window, with the harness's spans around each layer. In those
epochs the device is synchronised before the snapshot span and at its
end, so that the span's host time covers the snapshot's own device work
and not the flushes still queued.
"""
from __future__ import annotations

import time

import torch

from sketchbench import check, traffic
from sketchbench.tracing import Recorder, span

TRACE_EPOCHS = 8
TRACE_START = 0.4
#: epoch offsets drawn per seed: far more epochs than a window can hold
MAX_EPOCHS = 1 << 16


def plan_for(config: dict, device):
    """The configuration's kernel tables as the device's installed plan.

    On the CPU, where tests drive the harness, ``'cuda'`` (the hand-written
    kernels) is replaced by ``'sorted'``, the plain matcher with the same bits.
    """
    from repro_torch.plan import ExecutionPlan, device_fingerprint
    on_card = torch.device(device).type == "cuda"
    kernels = {op: {int(k): (impl if on_card or impl != "cuda" else "sorted")
                    for k, impl in table.items()}
               for op, table in config["plan"]["kernels"].items()}
    return ExecutionPlan(fingerprint=device_fingerprint(device), source="measured",
                         kernels=kernels, reductions={}, pods={},
                         chunk=config["chunk"], buffer_depth=config["buffer_depth"])


class System:
    """The system under test: a StreamRuntime and its QueryFrontend."""

    def __init__(self, config: dict, device):
        from repro_torch.engine import EngineConfig
        from repro_torch.runtime import RuntimeConfig, StreamRuntime
        engine = EngineConfig(k=config["k_counters"], tenants=config["lanes"],
                              chunk=config["chunk"], buffer_depth=config["buffer_depth"],
                              kernel="auto", count_dtype=config["count_dtype"],
                              device=str(device))
        self.runtime = StreamRuntime(RuntimeConfig(engine=engine, shards=config["shards"]))
        self.frontend = self.runtime.frontend()
        self.config = config
        on_card = torch.device(device).type == "cuda"
        self.sync = torch.cuda.synchronize if on_card else (lambda: None)

    def epoch(self, blocks, traced: bool = False) -> dict:
        rt, fe, cfg = self.runtime, self.frontend, self.config
        state = rt.init()
        last = len(blocks) - 1
        for j, block in enumerate(blocks):
            if j == last:
                t_hand = time.perf_counter()
            with span("ingest", traced):
                state = rt.ingest(state, block)
        if traced:
            self.sync()
        with span("snapshot", traced):
            snap = rt.snapshot(state)
            if traced:
                self.sync()
        with span("report", traced):
            rep = fe.k_majority_report(snap, cfg["k_majority"])
            items, counts = fe.top(snap, cfg["top_n"])
            top = (items.cpu().numpy(), counts.cpu().numpy())
        latency = time.perf_counter() - t_hand
        report = {"n": rep.n, "threshold": rep.threshold,
                  "guaranteed_items": rep.guaranteed_items,
                  "guaranteed_counts": rep.guaranteed_counts,
                  "guaranteed_lower": rep.guaranteed_lower,
                  "unconfirmed_items": rep.unconfirmed_items,
                  "unconfirmed_counts": rep.unconfirmed_counts,
                  "unconfirmed_lower": rep.unconfirmed_lower}
        return {"n": rep.n, "summary": tuple(snap.summary), "report": report,
                "top": top, "latency_s": latency}


def run(config: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    """One run: set-up, the window, then the check. ``t_start`` is the
    process's start on the ``time.perf_counter`` clock."""
    from repro_torch.plan import use_plan
    traffic.validate(mix)
    on_card = torch.device(device).type == "cuda"
    marks = {"runner": time.perf_counter() - t_start}
    with use_plan(plan_for(config, device)):
        system = System(config, device)
        marks["system"] = time.perf_counter() - t_start
        pool = traffic.make_pool(mix, seed, device)
        system.sync()
        marks["pool"] = time.perf_counter() - t_start
        offsets = traffic.epoch_offsets(mix, seed, MAX_EPOCHS + 1)
        recorder = Recorder() if trace else None
        system.epoch(check.epoch_blocks(pool, int(offsets[0]), mix))   # warm-up
        system.sync()
        setup_s = marks["warm"] = time.perf_counter() - t_start

        answers, traced, recorded = [], 0, None

        def one(spans=False):
            off = int(offsets[1 + len(answers)])
            a = system.epoch(check.epoch_blocks(pool, off, mix), traced=spans)
            answers.append(dict(a, offset=off))

        t0 = time.perf_counter()
        while True:
            tracing = recorder is not None and recorded is None and (
                traced > 0 or time.perf_counter() - t0 >= TRACE_START * seconds)
            if tracing and traced == 0:
                recorder.start()
                one()           # the profiler's start-up lands in this unspanned epoch
            one(tracing)
            if tracing:
                traced += 1
                if traced == TRACE_EPOCHS:
                    recorded = recorder.stop()
            if time.perf_counter() - t0 >= seconds and (recorder is None or recorded is not None):
                break
        window_s = time.perf_counter() - t0
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        del system
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers, failed = check.compare(answers, pool=pool, mix=mix, config=config, seed=seed)
        check_s = time.perf_counter() - t_check
    return {
        "setup_s": setup_s, "setup_marks": marks, "window_s": window_s, "epochs": len(answers),
        "items": len(answers) * mix["epoch_items"],
        "latencies_s": [a["latency_s"] for a in answers],
        "trace": recorded,
        "traced_epochs": traced, "traced_items": traced * mix["epoch_items"],
        "memory_peak_bytes": memory_peak, "numbers": numbers,
        "attempted": len(answers), "failed": failed, "check_s": check_s,
    }
