"""The reduction of a profile: busy time as the union of the device's
operations inside the traced window, launches without copies, idle gaps
named by the benchmark's span and the host operation they fell in."""

from typing import NamedTuple

import torch

from benchmark.core import trace


class Ev(NamedTuple):
    n: str
    kind: str
    a: int
    b: int
    thread: int = 1

    def name(self): return self.n
    def start_ns(self): return self.a
    def end_ns(self): return self.b
    def start_thread_id(self): return self.thread

    def device_type(self):
        dt = torch.autograd.DeviceType
        return dt.CUDA if self.kind.startswith(("kernel", "gpu")) else dt.CPU


def events():
    us = 1000
    return [
        Ev(trace.WINDOW_SPAN, "user_annotation", 0, 100 * us),
        Ev("bench_unit", "user_annotation", 0, 100 * us),
        # the profiler's mirror of the spans on the device's timeline
        Ev(trace.WINDOW_SPAN, "gpu_user_annotation", 0, 100 * us),
        Ev("bench_unit", "gpu_user_annotation", 0, 100 * us),
        Ev("aten::mul", "cpu_op", 5 * us, 15 * us),
        Ev("cudaLaunchKernel", "cuda_runtime", 40 * us, 45 * us),
        Ev("aten::other", "cpu_op", 0, 1, thread=2),
        Ev("k_a", "kernel", 10 * us, 30 * us),
        Ev("k_b", "kernel", 20 * us, 35 * us),      # overlaps k_a
        Ev("Memcpy DtoH", "gpu_memcpy", 50 * us, 60 * us),
        Ev("k_a", "kernel", 90 * us, 110 * us),     # runs past the window
        Ev("k_c", "kernel", 120 * us, 130 * us),    # after the window
    ]


def test_busy_launches_and_ops():
    t = trace.reduce_events(events(), units=2)
    assert abs(t.window_s - 100e-6) < 1e-12
    # [10, 35] + [50, 60] + [90, 100] us
    assert abs(t.busy_s - 45e-6) < 1e-12
    assert t.launches() == 3                 # k_a twice, k_b; no copy
    assert t.launches(lambda k: k == "k_a") == 2
    assert "k_c" not in t.device_ops
    assert t.units == 2


def test_idle_gaps_by_host_activity():
    t = trace.reduce_events(events(), units=2)
    gaps = t.idle_gaps
    # [0, 10] mid 5 us: inside aten::mul; [35, 50] mid 42.5: the launch;
    # [60, 90] mid 75: only the tick span
    assert abs(gaps["unit___aten::mul"] - 10e-6) < 1e-12
    assert abs(gaps["unit___cudaLaunchKernel"] - 15e-6) < 1e-12
    assert abs(gaps["unit"] - 30e-6) < 1e-12
    b = t.breakdown()
    assert [k for k, _ in b["idle_gaps"]][0] == "unit"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_no_device_operation_raises():
    import pytest
    with pytest.raises(RuntimeError):
        trace.reduce_events(events()[:5], units=1)
