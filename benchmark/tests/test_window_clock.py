"""The window's arithmetic on a fake clock: it closes at the end of the
unit that crosses the mark, counts all the work over all the time, and
takes the tail over every unit."""

import statistics

from benchmark.core.window import percentile, run_window


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def units(clock, durations, work=10):
    it = iter(durations)

    def unit():
        clock.now += next(it)
        return work
    return unit


def test_closes_on_the_unit_that_crosses_the_mark():
    clock = FakeClock()
    w = run_window(units(clock, [0.4] * 7 + [5.0] + [1.0] * 10), 3.0, clock)
    # 7 units reach 2.8 s; the eighth crosses 3 s and ends at 7.8 s
    assert w.units == 8
    assert abs(w.elapsed_s - 7.8) < 1e-12
    assert w.work == 80
    assert abs(w.rate() - 80 / 7.8) < 1e-12


def test_a_unit_ending_on_the_mark_closes_the_window():
    clock = FakeClock()
    w = run_window(units(clock, [1.0] * 10), 3.0, clock)
    assert w.units == 3 and w.elapsed_s == 3.0


def test_tail_over_every_unit():
    clock = FakeClock()
    ds = [0.125] * 4 + [0.875] + [0.125] * 20
    w = run_window(units(clock, ds), 2.0, clock)
    # 0.5 s, then the slow unit to 1.375 s, then five more to 2.0 s
    assert w.units == 10
    assert w.unit_s == ds[:10]
    want = statistics.quantiles(ds[:10], n=100, method="inclusive")[94]
    assert abs(w.unit_percentile_ms(95) - want * 1e3) < 1e-9
    assert w.unit_percentile_ms(95) > 0.125e3


def test_percentile_matches_numpy_linear():
    import numpy as np
    xs = list(np.random.default_rng(0).random(53))
    for p in (50, 90, 95, 99):
        assert abs(percentile(xs, p) - np.percentile(xs, p)) < 1e-12
