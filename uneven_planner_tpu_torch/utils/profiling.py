"""Tracing and throughput instrumentation (port of
`uneven_planner_tpu/utils/profiling.py`).

- `trace(log_dir)`: a context manager around `torch.profiler` (host and
  CUDA activity) that writes a Chrome trace into `log_dir`; the profile
  object is yielded, so `device_time_by_kernel` can read it.
- `device_time_by_kernel(prof)`: total device time and the time by kernel
  name of a profiled run.
- `span(name)`: a span of the program (named with SPAN_PREFIX) on the
  profiler's own clock while a profiler records, a shared no-op otherwise.
- `host_reads`, `read_host(site, t)`, `reset_host_reads()`: the count, by
  site, of the explicit reads of a device tensor's value on the host on the
  tracking tick's and the QP's paths.
- `solver_stats`: the summary of a batched ALMResult (converged share,
  iteration percentiles) behind the solves/s figure.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

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


# the program's spans are named with this prefix
SPAN_PREFIX = "up."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The program's span `name` (SPAN_PREFIX first) while a profiler
    records: a RecordFunction of the operator kind, so that the profile
    holds it on the host's timeline and on the profiler's clock, with no
    mirror on the device's timeline (`record_function` makes one, which a
    reader of the device's operations would take for one).  With no
    profiler recording, the shared no-op context and nothing else."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    # a private class of PyTorch, checked on 2.11 and 2.13; a rename fails
    # tests/test_torch_spans.py on the CPU
    return torch._C._profiler._RecordFunctionFast(name)


# explicit reads of a device tensor's value on the host on the tracking
# tick's and the QP's paths, by site; only `read_host` adds to it
host_reads = {"mpc_step.done": 0, "nonzero_counts": 0, "solve_qp.done": 0,
              "solve_qp.adapt": 0}


def reset_host_reads():
    for k in host_reads:
        host_reads[k] = 0


def read_host(site: str, t: torch.Tensor):
    """`t.tolist()`, counted under `site` of `host_reads` (on the card a
    copy to the host that waits for the device)."""
    host_reads[site] += 1
    return t.tolist()


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
