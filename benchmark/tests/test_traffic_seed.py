"""The traffic is a function of `--seed` alone: the same seed gives the
same inputs, every seed the same sizes, and seeds past 32 signed bits
work."""

import numpy as np
import pytest

from benchmark.core import cells, traffic

TRAFFIC = cells.resolve("hill.fleet4096").traffic
SEEDS = [0, 7, 2 ** 31 + 12345, 3 * 2 ** 32 + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_starts_repeat_in_the_seed(seed):
    for e in (-1, 0, 5):
        a = traffic.fleet_starts(TRAFFIC, seed, e)
        b = traffic.fleet_starts(TRAFFIC, seed, e)
        assert a.shape == (TRAFFIC["lanes"], 3) and a.dtype == np.float32
        assert np.array_equal(a, b)
    assert not np.array_equal(traffic.fleet_starts(TRAFFIC, seed, 0),
                              traffic.fleet_starts(TRAFFIC, seed, 1))


def test_fleet_starts_differ_between_seeds_within_the_spread():
    a = traffic.fleet_starts(TRAFFIC, SEEDS[0], 0)
    b = traffic.fleet_starts(TRAFFIC, SEEDS[2], 0)
    assert not np.array_equal(a, b)
    x0, y0, yaw0 = TRAFFIC["start_pose"]
    dxy, dyaw = TRAFFIC["start_spread"]
    for s in (a, b):
        assert np.all(np.abs(s[:, 0] - x0) <= dxy)
        assert np.all(np.abs(s[:, 2] - yaw0) <= dyaw + 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_checked_ticks_repeat_in_the_seed(seed):
    picks = [traffic.fleet_sampled_lanes(TRAFFIC, seed, k) for k in range(400)]
    again = [traffic.fleet_sampled_lanes(TRAFFIC, seed, k)
             for k in range(400)]
    assert picks[0] is not None, "the first tick is always compared"
    for a, b in zip(picks, again):
        assert (a is None and b is None) or np.array_equal(a, b)
    kept = [p for p in picks if p is not None]
    assert all(len(p) == TRAFFIC["check"]["lanes"] for p in kept)
    assert 10 <= len(kept) <= 70
