"""Share of the traced build's wall time in which the device ran nothing."""


def read(run):
    return None if run.trace is None else run.trace.idle_percent()
