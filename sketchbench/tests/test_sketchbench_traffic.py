"""The device-side generator: the same seed gives the same pool and epochs."""
import numpy as np
import pytest
import torch

from sketchbench import traffic
from sketchbench.tests.conftest import tiny

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_and_offsets_are_deterministic_per_seed(seed):
    mix = tiny().mix
    a, b = traffic.make_pool(mix, seed, "cpu"), traffic.make_pool(mix, seed, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32 and a.numel() == mix["pool_items"]
    np.testing.assert_array_equal(traffic.epoch_offsets(mix, seed, 50),
                                  traffic.epoch_offsets(mix, seed, 50))
    assert traffic.sample_epochs(seed, 100, 4) == traffic.sample_epochs(seed, 100, 4)


def test_seeds_change_the_ids_not_the_sizes():
    mix = tiny().mix
    a, b = traffic.make_pool(mix, 1, "cpu"), traffic.make_pool(mix, 2, "cpu")
    assert a.shape == b.shape and not torch.equal(a, b)
    for seed in (1, 2):
        off = traffic.epoch_offsets(mix, seed, 1000)
        assert (off % mix["offset_align"] == 0).all()
        assert off.min() >= 0 and off.max() + mix["epoch_items"] <= mix["pool_items"]


def test_pool_follows_the_truncated_zipf_law():
    mix = tiny(skew=1.1).mix
    pool = traffic.make_pool(mix, 3, "cpu")
    assert int(pool.min()) >= 1 and int(pool.max()) <= mix["max_id"]
    counts = torch.bincount(pool.long(), minlength=mix["max_id"] + 1).double()
    cdf = traffic.zipf_cdf(mix["skew"], mix["max_id"], "cpu")
    want_top = float(cdf[0]) * mix["pool_items"]
    assert abs(float(counts[1]) - want_top) < 5 * want_top ** 0.5
    assert float(counts[1]) > float(counts[2]) > float(counts[10])


def test_a_bad_mix_is_refused():
    mix = dict(tiny().mix, epoch_items=(1 << 14) + 1)
    with pytest.raises(ValueError):
        traffic.validate(mix)
