"""The traced stretch of a `--trace 1` run: a `torch.profiler` record of
host and device activity over a few whole units, reduced to what the
per-layer readers and the result line need.

After `utils/profiling.py` of the program (`trace`, `device_time_by_kernel`),
frozen here so that the yardstick does not move with the program: device
time by kernel name from the profiler's own events, and on top of it the
busy time (the union of the device's operations), the idle gaps between
them and what the host was doing in each.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, NamedTuple, Tuple

import torch

WINDOW_SPAN = "bench_traced_window"
# the benchmark's own spans are named with this prefix
SPAN_PREFIX = "bench_"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    units: int
    # name -> (device seconds, operations) of every device operation
    device_ops: Dict[str, Tuple[float, int]]
    # host activity -> idle seconds of the device under it
    idle_gaps: Dict[str, float]
    # names of the device operations that are copies or fills
    copies: frozenset = frozenset()

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(s for k, (s, _) in self.device_ops.items() if match(k))

    def launches(self, match=None) -> int:
        """Kernel launches (copies and fills left out) whose name `match`
        accepts, all by default."""
        return sum(c for k, (_, c) in self.device_ops.items()
                   if k not in self.copies and (match is None or match(k)))

    def idle_percent(self) -> float:
        """Share of the traced window in which the device ran nothing."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, s) for k, (s, _) in self.device_ops.items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short(k), s] for k, s in ops],
                "idle_gaps": [[short(k), s] for k, s in gaps]}


def short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:]", "_", name)[:64]


class Recorder:
    """Holds the profile of a `traced()` block until it is reduced."""
    prof = None
    units = 0


@contextlib.contextmanager
def traced():
    """Profile the block (host and device), inside one span that marks the
    traced window; the block ends with the device synchronised."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rec = Recorder()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield rec
            torch.cuda.synchronize()
    rec.prof = prof


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(rec: Recorder) -> Trace:
    """Reduce a profile to the Trace; raises if the device ran nothing."""
    return reduce_events(rec.prof.profiler.kineto_results.events(),
                         rec.units)


def reduce_events(events, units: int) -> Trace:
    """The Trace of the profiler's events (`name()`, `device_type()`,
    `start_ns()`, `end_ns()`, `start_thread_id()`): device operations are
    the CUDA ones, copies and fills named `Memcpy` / `Memset`, and the
    host's spans of the benchmark named with SPAN_PREFIX."""
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events
              if e.name() == WINDOW_SPAN and e.device_type() != cuda]
    if not window:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    thread = window[0].start_thread_id()

    ops: Dict[str, List[float]] = {}
    spans = []
    host = []
    copies = set()
    for e in events:
        if e.name().startswith(SPAN_PREFIX):
            # the benchmark's spans; the profiler mirrors them on the
            # device's timeline, where they are no device operation
            if e.device_type() != cuda and e.start_thread_id() == thread \
                    and e.name() != WINDOW_SPAN:
                host.append((e.start_ns(), e.end_ns(), e.name(), True))
            continue
        if e.device_type() == cuda:
            if e.name().startswith(("Memcpy", "Memset")):
                copies.add(e.name())
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b <= a:
                continue
            rec_ = ops.setdefault(e.name(), [0.0, 0])
            rec_[0] += (e.end_ns() - e.start_ns()) * 1e-9
            rec_[1] += 1
            spans.append((a, b))
        elif e.start_thread_id() == thread:
            host.append((e.start_ns(), e.end_ns(), e.name(), False))
    if not spans:
        raise RuntimeError("the profiler recorded no device operation")
    busy = _merge(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, units=units,
                 device_ops={k: (v[0], v[1]) for k, v in ops.items()},
                 idle_gaps=_attribute(gaps, host), copies=frozenset(copies))


def _attribute(gaps, host) -> Dict[str, float]:
    """Idle seconds by what the host thread was inside at each gap's
    middle: the innermost span of the benchmark (prefix dropped) and the
    innermost operation under it, as `span___op`."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out: Dict[str, float] = {}
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        spans = [h[2][len(SPAN_PREFIX):] for h in stack if h[3]]
        inner = [h[2] for h in stack if not h[3]]
        name = "___".join(([spans[-1]] if spans else ["host"])
                          + ([inner[-1]] if inner else []))
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out
