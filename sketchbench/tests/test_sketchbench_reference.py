"""The plain reference against the port's ``sorted`` path at a tiny size."""
import numpy as np
import pytest
import torch

from sketchbench import check, reference, traffic
from sketchbench.tests.conftest import tiny


def _port_epoch(cfg, blocks, kernel="sorted"):
    from repro_torch.engine import EngineConfig
    from repro_torch.runtime import RuntimeConfig, StreamRuntime
    eng = EngineConfig(k=cfg["k_counters"], tenants=cfg["lanes"], chunk=cfg["chunk"],
                       buffer_depth=cfg["buffer_depth"], kernel=kernel,
                       count_dtype=cfg["count_dtype"], device="cpu")
    rt = StreamRuntime(RuntimeConfig(engine=eng, shards=1))
    state = rt.init()
    for b in blocks:
        state = rt.ingest(state, b)
    snap = rt.snapshot(state)
    return snap, rt.frontend()


@pytest.mark.parametrize("count_dtype,skew", [("int32", 1.1), ("int32", 1.8), ("int64", 1.1)])
def test_reference_equals_the_port_bit_for_bit(count_dtype, skew):
    cell = tiny(skew=skew)
    cfg = dict(cell.config, count_dtype=count_dtype)
    pool = traffic.make_pool(cell.mix, 123, "cpu")
    off = int(traffic.epoch_offsets(cell.mix, 123, 1)[0])
    blocks = check.epoch_blocks(pool, off, cell.mix)
    snap, fe = _port_epoch(cfg, blocks)
    (items, counts, errors), n = reference.merged_epoch(
        blocks, k=cfg["k_counters"], lanes=cfg["lanes"],
        window=cfg["chunk"] * cfg["buffer_depth"], count_dtype=getattr(torch, count_dtype))
    assert n == int(snap.n) == cell.mix["epoch_items"]
    for got, want in zip(snap.summary, (items, counts, errors)):
        np.testing.assert_array_equal(got.numpy(), want)
    rep = fe.k_majority_report(snap, cfg["k_majority"])
    want = reference.report(items, counts, errors, n, cfg["k_majority"])
    for key, w in want.items():
        np.testing.assert_array_equal(np.asarray(getattr(rep, key)), w)
    t_items, t_counts = fe.top(snap, cfg["top_n"])
    w_items, w_counts = reference.top(items, counts, cfg["top_n"])
    np.testing.assert_array_equal(t_items.numpy(), w_items)
    np.testing.assert_array_equal(t_counts.numpy(), w_counts)


def test_histogram_drops_empty_ids_and_orders_ascending():
    w = torch.tensor([[5, -1, 3, 5, 9, -1, 3, 5]], dtype=torch.int32)
    ids, counts = reference.histogram(w, torch.int32)
    assert ids.tolist() == [[3, 5, 9, -1, -1, -1, -1, -1]]
    assert counts.tolist() == [[2, 3, 1, 0, 0, 0, 0, 0]]


def test_combine_offsets_and_ties_follow_the_paper():
    # k 2: s1 full {1: 5, 2: 3}; s2 full {2: 4, 3: 4}; m1 = 3, m2 = 4
    s1 = reference.Sketch(torch.tensor([[1, 2]], dtype=torch.int32),
                          torch.tensor([[5, 3]]), torch.tensor([[0, 1]]))
    s2 = reference.Sketch(torch.tensor([[2, 3]], dtype=torch.int32),
                          torch.tensor([[4, 4]]), torch.tensor([[0, 2]]))
    out = reference.combine(s1, s2)
    # 1: 5 + m2 = 9 (ε 4); 2: 3 + 4 = 7 (ε 1); 3: 4 + m1 = 7 (ε 5): 2 wins the tie
    assert out.items.tolist() == [[1, 2]]
    assert out.counts.tolist() == [[9, 7]] and out.errors.tolist() == [[4, 1]]


def test_the_narrow_control_differs_from_the_reference():
    cell = tiny(skew=1.8, pool_items=1 << 19, epoch_items=1 << 18, block_items=1 << 16)
    cfg = cell.config
    pool = traffic.make_pool(cell.mix, 9, "cpu")
    blocks = check.epoch_blocks(pool, 0, cell.mix)
    kw = dict(k=cfg["k_counters"], lanes=cfg["lanes"],
              window=cfg["chunk"] * cfg["buffer_depth"])
    (_, c32, _), _ = reference.merged_epoch(blocks, count_dtype=torch.int32, **kw)
    (_, c16, _), _ = reference.merged_epoch(blocks, count_dtype=torch.int16, **kw)
    assert c32.max() > np.iinfo(np.int16).max
    assert not np.array_equal(c32, c16.astype(np.int32))
