"""The comparison that decides ``correct``: sound runs pass, the control and
each fault of the timed path that a cell can have fail.

The faults are planted in the port underneath a whole run of the harness,
which skips only its look for a card (the run is on the CPU, at the tiny
sizes of ``conftest.TINY_*``)."""
import pytest
import torch

from sketchbench import check, control, harness
from sketchbench.tests.conftest import tiny


def _run(cell, seed=21, trace=False):
    result, verdict, record = harness.run_cell(cell, seed=seed, seconds=0.3, trace=trace,
                                               device="cpu", t_start=0.0)
    return result, verdict


@pytest.mark.parametrize("cell_name,trace", [("k2000.epoch256m.zipf11", False),
                                             ("k2000.epoch256m.zipf18", True),
                                             ("k8000.epoch256m.zipf11", False)])
def test_a_sound_run_is_correct(cell_name, trace):
    result, verdict = _run(tiny(cell_name), trace=trace)
    assert result["correct"] and result["failed"] == 0, verdict
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(check.LIMITS)


def _unchanged_flush(monkeypatch):
    from repro_torch.core.spacesaving import EMPTY
    from repro_torch.engine.engine import SketchEngine
    from repro_torch.engine.state import SketchState

    def flush(self, state):
        state.buffer.fill_(EMPTY)
        return SketchState(state.summary, state.buffer, 0, state.n)
    monkeypatch.setattr(SketchEngine, "_flush", flush)


def _half_the_batch(monkeypatch):
    from repro_torch.runtime.runtime import StreamRuntime
    orig = StreamRuntime.ingest

    def ingest(self, state, stream):
        half = stream[: stream.shape[0] // 2]
        state = orig(self, state, half)
        # the mean over the half kept, scaled to the whole: n doubled
        return state._replace(n=state.n * 2)
    monkeypatch.setattr(StreamRuntime, "ingest", ingest)


def _no_reduction(monkeypatch):
    from repro_torch.core.spacesaving import Summary
    from repro_torch.engine.engine import SketchEngine
    monkeypatch.setattr(SketchEngine, "_reduce",
                        lambda self, stacked: Summary(*(a[0] for a in stacked)))


def _altered_answer(monkeypatch):
    from repro_torch.service.frontend import QueryFrontend
    orig = QueryFrontend.k_majority_report

    def report(self, snap, k_majority):
        rep = orig(self, snap, k_majority)
        rep.guaranteed_counts[:1] += 1
        return rep
    monkeypatch.setattr(QueryFrontend, "k_majority_report", report)


@pytest.mark.parametrize("fault", [_unchanged_flush, _half_the_batch, _no_reduction,
                                   _altered_answer])
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, verdict = _run(tiny())
    assert not result["correct"], verdict
    assert result["failed"] >= 1


def test_the_control_fails_at_a_size_a_test_holds():
    """The reference with int16 counts in the system's place (``control.py``),
    at sizes whose counts pass 2^15, as the cells' do."""
    cell = tiny("k2000.epoch256m.zipf18", pool_items=1 << 19, epoch_items=1 << 18,
                block_items=1 << 16)
    numbers = control.control_numbers(cell, 31, "cpu")
    verdict = check.verdict(numbers)
    assert not all(v["ok"] for v in verdict.values())
    assert numbers["summary_mismatch"] > 0 and numbers["report_mismatch"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_control_fails_at_the_cells_size(card, seed):
    cell = harness.Cell("k2000.epoch256m.zipf11")
    numbers = control.control_numbers(cell, seed, card)
    assert numbers["summary_mismatch"] > 0 and numbers["report_mismatch"] > 0
    torch.cuda.empty_cache()
