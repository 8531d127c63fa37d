"""The comparison's control: the plain reference in TF32 put in the
program's place must come out not correct, and the program correct, on
the same kept ticks or cells.  On the card `studies/limits.py` reads both
at the cell's own size; here a few lanes, or a corner of the map, on the
CPU."""

import pytest
import torch

from benchmark.core import cells, window
from benchmark.reference.arith import Arith, round_tf32
from benchmark.tests.helpers import small_cell


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.benchmark_json()["workloads"]])
def test_control_fails_and_program_passes(workload, one_thread):
    cell = small_cell(workload)
    Driver = cells.load_module(cell.driver_path, "driver").Driver
    d = Driver(cell, 2300000007, "cpu")
    d.setup()
    d.start_counting()
    window.run_window(d.unit, 0.0)        # the start, compared
    for _ in range(5 if cell.traffic["driver"] == "fleet" else 0):
        d.unit()
    d.release()
    program = d.readings()
    control = d.readings(Arith(tf32=True))
    assert all(program[k] <= v for k, v in cell.limits.items()), program
    assert any(control[k] > v for k, v in cell.limits.items()), control


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-7])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0            # a tie rounds to even
    assert r[2] == 1.0 + 2 ** -9
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
