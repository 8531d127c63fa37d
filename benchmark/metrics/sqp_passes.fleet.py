"""Relinearisation passes a lane makes a tick, mean over the window
(`TrackResult`'s / `tick`'s `sqp_iters`)."""


def read(run):
    c = run.counters.get("window")
    if not c or c["ticks"] == 0:
        return None
    return c["sqp_passes"] / (c["ticks"] * c["lanes"])
