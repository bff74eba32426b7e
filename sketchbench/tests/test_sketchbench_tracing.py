"""The reading of a profiler trace: spans, launches, busy time and gaps."""
import pytest

from sketchbench.tracing import Trace, short_name


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "sketchbench.ingest", 0, 100),
    _x("cpu_op", "aten::copy_", 10, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernelExC", 50, 2, correlation=2),
    _x("user_annotation", "sketchbench.snapshot", 120, 40),
    _x("cuda_runtime", "cudaLaunchKernel", 125, 2, correlation=3),
    _x("kernel", "void (anonymous namespace)::fused_ingest_cluster_kernel<int>(int const*)",
       60, 50, correlation=2),
    _x("kernel", "void at::native::copy_kernel(int)", 20, 10, correlation=1),
    _x("kernel", "void (anonymous namespace)::fused_combine_kernel<int>(int)", 130, 20,
       correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH", 155, 10, correlation=99),
    _x("user_annotation", "other.span", 0, 500),
]


def test_ops_belong_to_the_span_that_launched_them():
    tr = Trace(EVENTS)
    assert tr.span_count("ingest") == 1 and tr.span_host_s("ingest") == pytest.approx(1e-4)
    # the cluster kernel ran after the ingest span ended, but was launched in it
    assert tr.span_device_s("ingest") == pytest.approx(60e-6)
    # the copy has no launch record: it counts where it started (in the snapshot span)
    assert tr.span_device_s("snapshot") == pytest.approx(30e-6)
    assert tr.unlaunched == 1
    assert tr.span_device_s("report") is None


def test_busy_window_and_breakdown():
    tr = Trace(EVENTS)
    assert tr.window() == (0, 160)
    assert tr.busy_s() == pytest.approx((10 + 50 + 20 + 5) * 1e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["fused_ingest_cluster_kernel<int>", pytest.approx(50e-6)]
    assert b["idle_gaps"][0][1] == pytest.approx(30e-6)
    assert b["idle_gaps"][0][0].startswith("ingest")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_short_names():
    assert short_name("void (anonymous namespace)::k<int>(int, int)") == "k<int>"
    assert short_name("Memcpy DtoH") == "Memcpy DtoH"
