"""Host seconds of a build, mean over the window: the bucketing and the
nearest-point seeds (`construct_map(timings=)["host_s"]`)."""


def read(run):
    c = run.counters.get("window")
    if not c or c.get("builds", 0) == 0:
        return None
    return c["host_s"] / c["builds"]
