"""Kernel launches per tick of the traced ticks (the profiler's kernels,
copies and fills left out): the host's dispatch work a tick."""


def read(run):
    if run.trace is None or run.trace.units == 0:
        return None
    return run.trace.launches() / run.trace.units
