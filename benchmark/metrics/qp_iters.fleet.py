"""ADMM iterations of one QP pass, mean over the window's passes
(`tick`'s `qp_iters` over its `sqp_iters`)."""


def read(run):
    c = run.counters.get("window")
    if not c or c["sqp_passes"] == 0:
        return None
    return c["qp_iterations"] / c["sqp_passes"]
