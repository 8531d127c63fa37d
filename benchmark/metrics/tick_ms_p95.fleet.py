"""95th percentile, over every tick of the window, of a tick's wall time
from its start to its commands read on the host (ms): the fleet's tail,
which the host's stalls move too far from run to run to bound end to
end."""


def read(run):
    if run.window is None or run.window.units == 0:
        return None
    return run.window.unit_percentile_ms(95)
