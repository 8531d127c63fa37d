#!/usr/bin/env python3
"""Where a fleet tick's time goes, by the program's spans, on one GPU.

    python3 chip_studies/tick_spans.py [--qp condensed|full] [--ticks 300]
        [--build] [--out PATH]

Tracks the figure-eight with LANES robots (starts within 5 cm and 0.1 rad
of its start pose, episodes of 256 ticks, three relinearisation passes a
tick, the commands read on the host every tick) and profiles `--ticks`
ticks, CHUNK to a profile.  Prints, a tick on average, the device time and
the host's own time under each program span (`up.*`, innermost at the
launch), the device's idle time by the span and the host operation it fell
in, where the allocator's and the synchronising runtime calls fall (span
and PyTorch operator), K6's and K7's launches by instantiation and the host
reads by site; then every slow tick (host clock, start to commands read,
over SLOW times the median tick) with the spans whose own host time
exceeds the median tick's most and the longest host operations in it.
Then, without the profiler, the slow ticks of the program as it is against
the same program with `torch.cholesky_inverse` (MAGMA's, which calls
`cudaMalloc` and `cudaFree` itself) computed by cuBLAS's triangular solve,
in blocks of BLOCK ticks in the order magma, cublas, cublas, magma.  Then
the spans' own cost: ticks with the program's spans against ticks with
`span` stubbed out, under the profiler and without it, each block the first
COST_TICKS ticks of an episode, in the order on, off, off, on, twice.
`--build` profiles one map build of `chip_smoke.py`'s hill cloud (mode xyz)
the same way.  `--out` writes everything as JSON (the slow ticks all, the
summary every key).
"""

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from uneven_planner_tpu_torch.config import MPCConfig  # noqa: E402
from uneven_planner_tpu_torch.kernels import admm as kadmm  # noqa: E402
from uneven_planner_tpu_torch.kernels import ruiz as kruiz  # noqa: E402
from uneven_planner_tpu_torch.minco.traj import expand_traj  # noqa: E402
from uneven_planner_tpu_torch.mpc import tracker, traj_msg  # noqa: E402
from uneven_planner_tpu_torch.sim import rollout  # noqa: E402
from uneven_planner_tpu_torch.solver import admm_qp  # noqa: E402
from uneven_planner_tpu_torch.terrain import build  # noqa: E402
from uneven_planner_tpu_torch.utils import profiling  # noqa: E402

LANES = 4096
SEED = 1
EPISODE = 256
CHUNK = 50          # ticks a profile
SLOW = 1.5          # a slow tick: over SLOW x the median tick
BLOCK = 100         # untraced ticks a block, per inverse
COST_TICKS = 30     # ticks a block of the spans' cost
CALLS = ("cudaFree", "cudaMalloc", "cudaStreamSynchronize",
         "cudaDeviceSynchronize", "cudaMemcpyAsync")
SPANNED = (rollout, tracker, admm_qp, kadmm, build)


def add(d, k, v):
    d[k] = d.get(k, 0.0) + v


def innermost_spans(spans, times) -> list:
    """For each time of `times` (ascending), the name of the innermost of
    `spans` ((start, end, name), properly nested) open at it; "" where none
    is."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "")
    return out


def program_spans(events) -> dict:
    """The program's spans among a torch.profiler run's events
    (`prof.profiler.kineto_results.events()`), as (start ns, end ns, name)
    by host thread."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in events:
        if e.device_type() != cuda \
                and e.name().startswith(profiling.SPAN_PREFIX):
            out.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), e.name()))
    return out


def launched_ops(events) -> dict:
    """The device's operations (kernels, copies and fills) as (launch ns,
    start ns, end ns), sorted, by the host thread that launched them.  An
    operation is linked to its launch, the host's runtime call (`cu...`),
    by their correlation id; the device-side mirrors of `record_function`
    spans are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    calls, ops = {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append(e)
        elif e.name().startswith("cu"):
            calls[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    out = {}
    for e in ops:
        call = calls.get(e.correlation_id())
        if call is not None:
            out.setdefault(call[0], []).append(
                (call[1], e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def device_time_by_span(events) -> dict:
    """Device seconds of a profiler run's events by the innermost program
    span the launching thread was in at each operation's launch, "" where
    it was in none; the values sum to the operations' device time."""
    spans = program_spans(events)
    out = {}
    for thread, ops in launched_ops(events).items():
        names = innermost_spans(spans.get(thread, ()), [t for t, _, _ in ops])
        for name, (_, a, b) in zip(names, ops):
            add(out, name, (b - a) * 1e-9)
    return out


def own_ms(spans) -> dict:
    """Each span's own time (ms), its children's left out, by name."""
    out, stack = {}, []
    for a, b, n in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            stack.pop()
        add(out, n, (b - a) * 1e-6)
        if stack:
            add(out, stack[-1][2], -(b - a) * 1e-6)
        stack.append((a, b, n))
    return out


class Profile:
    """One profile's events, split into what the study reads: the main
    thread's program spans and host operations, and the device's
    operations with the innermost span at their launch."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        spans = program_spans(events)
        self.thread = max(spans, key=lambda t: len(spans[t]))
        self.spans = sorted(spans[self.thread])
        self.host = sorted(
            (e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.device_type() != cuda and e.start_thread_id() == self.thread
            and not e.name().startswith(profiling.SPAN_PREFIX))
        self.host_at = [h[0] for h in self.host]
        launched = launched_ops(events).get(self.thread, [])
        names = innermost_spans(self.spans, [t for t, _, _ in launched])
        self.ops = [(t, a, b, n) for (t, a, b), n in zip(launched, names)]
        self.ops_at = [o[0] for o in self.ops]
        busy = []
        for a, b in sorted((a, b) for _, a, b, _ in self.ops):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        self.busy = busy
        self.busy_at = [b for _, b in busy]

    def _host(self, lo, hi):
        return self.host[bisect.bisect_left(self.host_at, lo):
                         bisect.bisect_left(self.host_at, hi)]

    def breakdown(self, lo, hi) -> dict:
        """Device ms, host own ms, idle ms by span and by span___op, and
        the runtime calls of CALLS (count, ms) by span, of [lo, hi)."""
        dev, idle, idle_op, calls = {}, {}, {}, {}
        for t, a, b, n in self.ops[bisect.bisect_left(self.ops_at, lo):
                                   bisect.bisect_left(self.ops_at, hi)]:
            add(dev, n or "(none)", (b - a) * 1e-6)
        inside = [s for s in self.spans if lo <= s[0] < hi]
        own = own_ms(inside)
        top = sum(b - a for a, b, n in inside
                  if n in ("up.tick", "up.construct_map")) * 1e-6
        add(own, "(none)", (hi - lo) * 1e-6 - top)
        gaps, prev = [], lo
        for a, b in self.busy[bisect.bisect_right(self.busy_at, lo):]:
            if a >= hi:
                break
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        mids = [(a + b) / 2 for a, b in gaps]
        host = self._host(lo, hi)
        where = innermost_spans(inside, mids)
        ops_at = innermost_spans(host, mids)
        for (a, b), n, op in zip(gaps, where, ops_at):
            n = n or "(none)"
            add(idle, n, (b - a) * 1e-6)
            add(idle_op, f"{n}___{op}" if op else n, (b - a) * 1e-6)
        named = [h for h in host if h[2] in CALLS]
        starts = [h[0] for h in named]
        aten = innermost_spans(
            [h for h in host if h[2].startswith("aten::")], starts)
        for (a, b, n), s, op in zip(named, innermost_spans(
                inside, starts), aten):
            c = calls.setdefault(f"{s or '(none)'}: {op or '-'}: {n}",
                                 [0, 0.0])
            c[0] += 1
            c[1] += (b - a) * 1e-6
        return {"device_ms": dev, "host_own_ms": own, "idle_ms": idle,
                "idle_ms_by_op": idle_op, "runtime_calls": calls}

    def longest_host(self, lo, hi, k=4):
        """The k longest host operations of [lo, hi) that are not
        PyTorch's operators (runtime calls, allocator, ...), with their
        span."""
        longest = sorted(((b - a, a, n) for a, b, n in self._host(lo, hi)
                          if not n.startswith("aten::")), reverse=True)[:k]
        starts = sorted(a for _, a, _ in longest)
        at = dict(zip(starts, innermost_spans(
            [s for s in self.spans if lo <= s[0] < hi], starts)))
        return [[n, round(d * 1e-6, 3), at[a] or "(none)"]
                for d, a, n in longest]


def merge(into, part, scale=1.0):
    for key, val in part.items():
        if isinstance(val, dict):
            merge(into.setdefault(key, {}), val, scale)
        elif isinstance(val, list):
            cur = into.setdefault(key, [0, 0.0])
            cur[0] += val[0]
            cur[1] += val[1]
        else:
            add(into, key, val * scale)


def rounded(d):
    if isinstance(d, dict):
        return {k: rounded(v) for k, v in sorted(
            d.items(), key=lambda kv: -abs(kv[1]) if isinstance(
                kv[1], (int, float)) else 0)}
    if isinstance(d, list):
        return [rounded(v) for v in d]
    return round(d, 4) if isinstance(d, float) else d


class Fleet:
    def __init__(self, qp, seed, dev):
        self.cfg = MPCConfig(qp_condense=(qp == "condensed"))
        self.seed, self.dev = seed, dev
        self.traj = expand_traj(traj_msg.figure_eight(
            0.5, 16, 1.2, dtype=torch.float32, device=dev), LANES)
        self.k = 0
        self.state = self.episode(-1)

    def episode(self, e):
        rng = np.random.default_rng([self.seed, e + 1])
        s0 = np.zeros((LANES, 3), np.float32)
        s0[:, :2] = rng.uniform(-0.05, 0.05, (LANES, 2))
        s0[:, 2] = np.pi / 4 + rng.uniform(-0.1, 0.1, LANES)
        return rollout.roll_init(torch.as_tensor(s0, device=self.dev),
                                 self.cfg)

    def tick(self):
        """One tick of the fleet ended by the commands' read; (host ms of
        the call, ms to the commands on the host)."""
        if self.k % EPISODE == 0:
            self.state = self.episode(self.k // EPISODE)
        t0 = time.perf_counter()
        self.state, out, _ = rollout.tick(self.traj, self.state, self.cfg,
                                          0.01, 3, None)
        t1 = time.perf_counter()
        out[1].cpu()
        self.k += 1
        return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3

    def warm(self):
        for _ in range(3):
            self.tick()
        torch.cuda.synchronize()


def traced(fn, n):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = [fn() for _ in range(n)]
        torch.cuda.synchronize()
    return out, prof.profiler.kineto_results.events()


def study_ticks(qp, ticks, dev):
    fleet = Fleet(qp, SEED, dev)
    fleet.warm()
    reads0, launches0 = dict(profiling.host_reads), dict(kadmm.launches)
    k7_0 = dict(kruiz.launches)
    total, rows = {}, []
    while len(rows) < ticks:
        n = min(CHUNK, ticks - len(rows))
        times, events = traced(fleet.tick, n)
        p = Profile(events)
        starts = [a for a, _, name in p.spans if name == "up.tick"]
        ends = starts[1:] + [max(b for _, b, _ in p.spans)]
        assert len(starts) == n, (len(starts), n)
        for (call, wall), lo, hi in zip(times, starts, ends):
            part = p.breakdown(lo, hi)
            merge(total, part)
            rows.append({"tick": len(rows), "call_ms": call,
                         "wall_ms": wall, "own": part["host_own_ms"],
                         "longest": p.longest_host(lo, hi)})
        del events, p
    n = len(rows)
    per_tick = {k: rounded({kk: (vv if isinstance(vv, list) else vv / n)
                            for kk, vv in v.items()})
                for k, v in total.items()}
    walls = [t["wall_ms"] for t in rows]
    median = statistics.median(walls)
    med_own = {k: statistics.median(t["own"].get(k, 0.0) for t in rows)
               for k in total["host_own_ms"]}
    slow = []
    for t in rows:
        if t["wall_ms"] > SLOW * median:
            excess = {k: v - med_own.get(k, 0.0) for k, v in t["own"].items()}
            top = sorted(excess.items(), key=lambda kv: -kv[1])[:4]
            slow.append({"tick": t["tick"], "wall_ms": round(t["wall_ms"], 2),
                         "call_ms": round(t["call_ms"], 2),
                         "own_ms_over_median": [[k, round(v, 2)]
                                                for k, v in top],
                         "longest_host_ops": t["longest"]})
    return {
        "qp": qp, "lanes": LANES, "ticks": n,
        "wall_ms_median": median,
        "wall_ms_p95": statistics.quantiles(walls, n=20)[-1],
        "slow_ms": SLOW * median,
        "call_ms_median": statistics.median(t["call_ms"] for t in rows),
        "host_reads_per_tick": {
            k: (profiling.host_reads[k] - reads0[k]) / n for k in reads0},
        "k6_launches_per_tick": {
            k: (kadmm.launches[k] - launches0[k]) / n for k in launches0},
        "k7_launches_per_tick": {
            k: (kruiz.launches[k] - k7_0[k]) / n for k in k7_0},
        "per_tick": per_tick,
        "slow_ticks": slow,
    }


def cublas_inverse(L):
    """`torch.cholesky_inverse(L)` of lower factors [B, n, n] by cuBLAS's
    batched triangular solve, whose work arrays come from PyTorch's
    caching allocator."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Li.mT @ Li


def untraced_stalls(qp, dev):
    """Wall ms a tick without the profiler, the program's inverse
    (`magma`) against `cublas_inverse` in its place (`cublas`), blocks of
    BLOCK ticks in the order magma, cublas, cublas, magma; per arm the
    median, the 95th percentile, the slow ticks (over SLOW x the arm's
    median) and the longest tick."""
    fleet = Fleet(qp, SEED + 2, dev)
    kept = torch.cholesky_inverse
    walls = {"magma": [], "cublas": []}
    for arm in ("magma", "cublas", "cublas", "magma"):
        torch.cholesky_inverse = kept if arm == "magma" else cublas_inverse
        try:
            fleet.warm()
            walls[arm] += [fleet.tick()[1] for _ in range(BLOCK)]
        finally:
            torch.cholesky_inverse = kept
    out = {}
    for arm, w in walls.items():
        med = statistics.median(w)
        out[arm] = {"ticks": len(w), "wall_ms_median": round(med, 3),
                    "wall_ms_p95": round(statistics.quantiles(w, n=20)[-1],
                                         3),
                    "slow": sum(x > SLOW * med for x in w),
                    "wall_ms_max": round(max(w), 3)}
    return out


def stub_spans():
    kept = {m: m.span for m in SPANNED}
    for m in SPANNED:
        m.span = lambda name: profiling._NO_SPAN
    return kept


def tracing_cost(qp, dev):
    """Median ms a tick (the call; to the commands) with the spans and
    with `span` stubbed, under the profiler and without it, in blocks of
    the first COST_TICKS ticks of one episode, in the order on, off, off,
    on, twice."""
    fleet = Fleet(qp, SEED + 1, dev)
    fleet.warm()
    out = {}
    for profiled in (True, False):
        for spans in (True, False, False, True) * 2:
            # every block the same ticks: the first of an episode
            fleet.k = 0
            kept = None if spans else stub_spans()
            try:
                if profiled:
                    times, events = traced(fleet.tick, COST_TICKS)
                    del events
                else:
                    times = [fleet.tick() for _ in range(COST_TICKS)]
            finally:
                for m, f in (kept or {}).items():
                    m.span = f
            key = f"{'traced' if profiled else 'untraced'}_" \
                  f"{'spans' if spans else 'stubbed'}"
            for j, name in ((0, "call_ms"), (1, "wall_ms")):
                out.setdefault(key, {}).setdefault(name, []).extend(
                    t[j] for t in times)
    return {k: {n: round(statistics.median(v), 3) for n, v in d.items()}
            for k, d in out.items()}


def study_build(dev):
    import chip_smoke
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.terrain import io
    raw = chip_smoke.build_cloud(SEED)[0]
    pts = io.voxel_downsample(io.crop_box(raw))
    cfg = scene_config("hill").map
    run = lambda: build.construct_map(pts, cfg, mode="xyz",
                                      device=dev).occ.cpu()
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, events = traced(run, 1)
    wall = time.perf_counter() - t0
    p = Profile(events)
    (lo, hi) = [(a, b) for a, b, n in p.spans if n == "up.construct_map"][0]
    hi = max(hi, max(b for _, _, b, _ in p.ops))
    return {"wall_s": wall, "points": int(len(pts)),
            **rounded(p.breakdown(lo, hi)),
            "longest_host_ops": p.longest_host(lo, hi, 8)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--qp", choices=("condensed", "full"),
                    default="condensed")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--out", help="JSON file for the whole result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tick_spans: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = {"card": card.strip(), "torch": torch.__version__}
    t0 = time.perf_counter()
    res["ticks"] = study_ticks(args.qp, args.ticks, dev)
    res["untraced_stalls"] = untraced_stalls(args.qp, dev)
    res["tracing_cost"] = tracing_cost(args.qp, dev)
    if args.build:
        res["build"] = study_build(dev)
    res["seconds"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    t = res["ticks"]
    print(json.dumps({k: t[k] for k in (
        "qp", "lanes", "ticks", "wall_ms_median", "wall_ms_p95",
        "call_ms_median", "host_reads_per_tick", "k6_launches_per_tick",
        "k7_launches_per_tick")}))
    for k, v in t["per_tick"].items():
        print(k, json.dumps(dict(list(v.items())[:14])))
    print(f"slow ticks (> {SLOW} x the median, {t['slow_ms']:.1f} ms): "
          f"{len(t['slow_ticks'])}")
    for s in t["slow_ticks"][:40]:
        print(json.dumps(s))
    for k in ("untraced_stalls", "tracing_cost", "build"):
        if k in res:
            print(k, json.dumps(res[k])[:6000])
    print(f"# {res['card']}, {res['seconds']:.1f} s")


if __name__ == "__main__":
    main()
