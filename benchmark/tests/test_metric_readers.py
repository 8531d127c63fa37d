"""Each per-layer reader returns nothing where it finds nothing to read,
and its number from counters and a trace."""

import pytest

from benchmark import run
from benchmark.core import cells, roofline, trace
from benchmark.core.window import Window

SPEC = cells.benchmark_json()
MPC = cells.resolve("hill.fleet4096").config["mpc"]


def reader(name):
    return cells.load_module(cells.reader_path(name), "reader")


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_nothing_to_read_gives_nothing(name):
    r = run.Run(cells.resolve(SPEC["workloads"][0]["name"]))
    assert reader(name).read(r) is None


def fleet_run():
    r = run.Run(cells.resolve("hill.fleet4096"))
    counts = {"ticks": 10, "lanes": 4096, "sqp_passes": 3 * 10 * 4096,
              "qp_iterations": 280 * 3 * 10 * 4096, "k6_launches": 30,
              "failed_ticks": 0, "qp_shape": MPC}
    r.counters = {"window": counts, "traced": counts}
    k6 = "void (anonymous namespace)::admm_kernel<60, 118>(args)"
    r.trace = trace.Trace(window_s=1.0, busy_s=0.7, units=10,
                          device_ops={k6: (0.3, 30), "ew": (0.4, 28000),
                                      "Memcpy DtoH": (0.001, 10)},
                          idle_gaps={}, copies=frozenset({"Memcpy DtoH"}))
    return r


def test_fleet_readers():
    r = fleet_run()
    assert reader("launches_per_tick.fleet").read(r) == 2803
    assert reader("sqp_passes.fleet").read(r) == 3
    assert reader("qp_iters.fleet").read(r) == 280
    assert abs(reader("device_idle.fleet").read(r) - 30.0) < 1e-9
    shape = roofline.tracking_qp_shape(MPC)
    flops, nbytes = roofline.k6_work(shape, 280 * 3 * 10 * 4096, 30 * 4096)
    want = 100 * max(flops / 67e12, nbytes / 3.35e12) / 0.3
    got = reader("k6_roofline.fleet").read(r)
    assert abs(got - want) < 1e-9 and 0 < got < 100


def test_tick_tail_over_every_tick_of_the_window():
    r = fleet_run()
    ticks = [0.08] * 90 + [0.5] * 10
    r.window = Window(elapsed_s=sum(ticks), work=4096 * 100, unit_s=ticks)
    # the 95th of 100 ticks lies among the ten slow ones
    assert abs(reader("tick_ms_p95.fleet").read(r) - 500.0) < 1e-9
    r.window = Window(elapsed_s=0.0, work=0, unit_s=[])
    assert reader("tick_ms_p95.fleet").read(r) is None


def test_tracking_qp_shapes():
    assert roofline.tracking_qp_shape(MPC) == dict(n=60, m=118, nnz_p=3600,
                                                   nnz_a=176)
    full = dict(MPC, qp_condense=False)
    assert roofline.tracking_qp_shape(full) == dict(n=150, m=208, nnz_p=266,
                                                    nnz_a=531)
