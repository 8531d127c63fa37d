"""The measured window: whole units of work until the time is up.

A unit (a tick of the fleet, a batch of solves, a map build) ends in a host
read of what it produced.  The window runs units back to back until
`seconds` have passed since it opened, and closes at the end of the unit
that crosses that mark: no unit is cut, dropped or counted in part.  Its
rates are all the work over all the time from the opening to that end;
its tails are taken over every unit.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple


class Window(NamedTuple):
    elapsed_s: float        # from the opening to the end of the last unit
    work: float             # the work of every unit, summed
    unit_s: List[float]     # each unit's wall time, start to host read

    @property
    def units(self) -> int:
        return len(self.unit_s)

    def rate(self) -> float:
        """Work per second over the whole window."""
        return self.work / self.elapsed_s

    def unit_percentile_ms(self, p: float) -> float:
        """The p-th percentile of the unit times over every unit, ms."""
        return percentile(self.unit_s, p) * 1e3


def percentile(values, p: float) -> float:
    """The p-th percentile, linear between order statistics (numpy's
    default, and `statistics.quantiles`' inclusive method)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_window(unit: Callable[[], float], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run `unit()` (which returns the work it did) until `seconds` have
    passed since the first call started; the unit that crosses the mark
    runs to its end and is counted whole."""
    start = clock()
    work, times = 0.0, []
    while True:
        t0 = clock()
        work += unit()
        t1 = clock()
        times.append(t1 - t0)
        if t1 - start >= seconds:
            return Window(t1 - start, work, times)
