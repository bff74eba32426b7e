"""The byte and operation counts at the two configurations' shapes."""
import pytest

from sketchbench import roofline

W = 8192 * 8


@pytest.mark.parametrize("k,flush_bytes,snapshot_bytes", [
    (2000, 64 * W * 4 + 2 * 64 * 2000 * 12, 63 * 3 * 2000 * 12),
    (8000, 64 * W * 4 + 2 * 64 * 8000 * 12, 63 * 3 * 8000 * 12),
])
def test_counts_at_the_configurations(k, flush_bytes, snapshot_bytes):
    assert roofline.flush_bytes(64, W, k, 4) == flush_bytes
    assert 63 * roofline.merge_bytes(k, 4) == snapshot_bytes
    assert roofline.flush_ops(64, W) == 64 * W
    # every bound here is the bytes term
    assert roofline.flush_least_s(64, W, k, 4) == pytest.approx(flush_bytes / 3.35e12)
    assert roofline.snapshot_least_s(64, k, 4) == pytest.approx(snapshot_bytes / 3.35e12)


def test_the_planned_flush_bound_of_the_kernel_table():
    # the kernel table's planned flush (B 64, k 2048, W 65 536): 0.005947 ms
    assert roofline.flush_least_s(64, W, 2048, 4) * 1e3 == pytest.approx(0.005947, abs=5e-7)
    assert roofline.snapshot_least_s(64, 2000, 4) * 1e6 == pytest.approx(1.354, abs=1e-3)


def test_int64_slots_and_unknown_cards():
    assert roofline.slot_bytes(8) == 20
    assert roofline.peaks("some other card") == roofline.peaks()
