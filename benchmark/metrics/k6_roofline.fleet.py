"""K6's share of its roofline over the traced ticks: the least time of the
ADMM iterations the lanes ran (operations from the nonzeros of this cell's
P and A, bytes of each lane's data read once a launch) over K6's device
time.  The same count whichever instantiation of K6 runs."""

from benchmark.core import roofline


def is_k6(name: str) -> bool:
    return "::admm_" in name and "_kernel" in name


def read(run):
    c = run.counters.get("traced")
    if run.trace is None or not c:
        return None
    device_s = run.trace.seconds(is_k6)
    shape = roofline.tracking_qp_shape(c["qp_shape"])
    flops, nbytes = roofline.k6_work(shape, c["qp_iterations"],
                                     c["k6_launches"] * c["lanes"])
    return roofline.share(flops, nbytes, device_s)
