"""Tracing and throughput instrumentation (port of
`uneven_planner_tpu/utils/profiling.py`).

- `trace(log_dir)`: a context manager around `torch.profiler` (host and
  CUDA activity) that writes a Chrome trace into `log_dir`; the profile
  object is yielded, so `device_time_by_kernel` can read it.
- `device_time_by_kernel(prof)`: total device time and the time by kernel
  name of a profiled run.
- `Stage`: named wall-clock stages that end with a device synchronization,
  collected into a report (the reference's per-stage millisecond prints).
- `solver_stats`: the summary of a batched ALMResult (converged share,
  iteration percentiles) behind the solves/s figure.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's host and CUDA activity (CUDA only where it is
    available) and write `log_dir/trace.json` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_time_by_kernel(prof):
    """(total device microseconds, [(microseconds, kernel name, calls)]
    sorted by time) from a torch.profiler run; raises if the profiler saw
    no device time."""
    rows, total = [], 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
            total += dev_us
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    rows.sort(reverse=True)
    return total, rows


class Stage:
    """Wall-clock stage timer that synchronizes the device at the end of a
    stage; accumulates the times by name."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        """Time the block; with `sync`, a tensor the block computes, the
        time ends when its device has finished."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.times.items():
            arr = np.asarray(ts) * 1e3
            lines.append(f"{name}: n={len(arr)} mean={arr.mean():.1f}ms "
                         f"p50={np.percentile(arr, 50):.1f}ms "
                         f"max={arr.max():.1f}ms")
        return "\n".join(lines)


def solver_stats(result) -> Dict[str, float]:
    """Converged share and iteration percentiles of a batched ALMResult."""
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    conv = host(result.converged)
    inner = host(result.inner_iters)
    outer = host(result.outer_iters)
    return {
        "batch": int(conv.size),
        "converged_frac": float(conv.mean()),
        "inner_p50": float(np.percentile(inner, 50)),
        "inner_p95": float(np.percentile(inner, 95)),
        "inner_max": int(inner.max()),
        "outer_p50": float(np.percentile(outer, 50)),
        "outer_max": int(outer.max()),
        "res_h_max": float(host(result.res_h).max()),
        "res_g_max": float(host(result.res_g).max()),
    }
