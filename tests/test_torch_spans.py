"""The program's spans (`utils.profiling.span`) and its count of host reads
(`utils.profiling.host_reads`) on the tracking tick, the QP and the map
builder's path, and the reduction of a profile to device time by span that
`chip_studies/tick_spans.py` makes.

The CPU tests profile a tick of a few lanes with the CPU profiler; the card
tests (`-m cuda`) hold the counter to the synchronising reads PyTorch's
sync debug mode reports, and the device time under each span to the
kernels' own, on one tick of each QP form.
"""

import math
import warnings
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chip_studies import tick_spans
from uneven_planner_tpu_torch.config import MapConfig, MPCConfig
from uneven_planner_tpu_torch.kernels import admm as kadmm
from uneven_planner_tpu_torch.minco.traj import expand_traj
from uneven_planner_tpu_torch.mpc import traj_msg
from uneven_planner_tpu_torch.sim import rollout
from uneven_planner_tpu_torch.solver import admm_qp
from uneven_planner_tpu_torch.terrain import build
from uneven_planner_tpu_torch.utils import profiling

PASS = ["up.mpc_step.assemble", "up.qp.setup", "up.qp.admm", "up.qp.finish"]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fleet(cfg, lanes, device, dtype):
    """The figure-eight for `lanes` robots and their start states (within a
    few cm and 0.1 rad of its start pose)."""
    traj = expand_traj(traj_msg.figure_eight(0.5, dtype=dtype, device=device),
                       lanes)
    gen = torch.Generator().manual_seed(lanes)
    s0 = torch.zeros((lanes, 3), dtype=torch.float64)
    s0[:, :2] = 0.04 * (torch.rand((lanes, 2), generator=gen) - 0.5)
    s0[:, 2] = math.pi / 4 + 0.1 * (torch.rand(lanes, generator=gen) - 0.5)
    return traj, rollout.roll_init(s0.to(device=device, dtype=dtype), cfg)


def _tree(spans):
    """[(name, children)] of properly nested (start, end, name) spans."""
    root = ("", [])
    stack = [(math.inf, root)]
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack[-1][0] <= a:
            stack.pop()
        node = (name, [])
        stack[-1][1][1].append(node)
        stack.append((b, node))
    return root[1]


def _names(nodes):
    return [n for n, _ in nodes]


def _check_tick_tree(spans, passes, full_on_card):
    (tick,) = _tree(spans)
    assert tick[0] == "up.tick"
    assert _names(tick[1]) == ["up.tick.refs", "up.mpc_step", "up.tick.plant"]
    refs, step, plant = tick[1]
    assert refs[1] == [] and plant[1] == []
    # one span a relinearisation pass that ran, nothing else under the step
    assert _names(step[1]) == ["up.mpc_step.pass"] * passes
    for _, inside in step[1]:
        assert _names(inside) == PASS
        for name, below in inside:
            # the nonzero counts are read only where the kernel is sized
            # by them: the full QP on the card; the equilibration is in the
            # setup's span on either device
            want = {"up.qp.admm": ["up.qp.nnz"] if full_on_card else [],
                    "up.qp.setup": ["up.qp.ruiz"]}.get(name, [])
            assert _names(below) == want and all(c == [] for _, c in below)


def _early_exit_checks(passes: int, cap: int) -> int:
    """`done.all()` reads the relinearisation loop makes: one before every
    pass but the first, and the one that ends the loop early."""
    return passes if passes < cap else cap - 1


@pytest.mark.parametrize("condense", [True, False], ids=["condensed", "full"])
def test_tick_spans_nest_one_pass_span_a_pass(condense):
    """A tick of 3 lanes under the CPU profiler: `up.tick` holds the
    reference sampling, the MPC step and the plant; the step one
    `up.mpc_step.pass` a pass it ran, each the assembly and the QP's setup
    (with the equilibration's `up.qp.ruiz` in it), iterations and finish,
    in that order."""
    cfg = MPCConfig(qp_condense=condense)
    traj, s = _fleet(cfg, 3, "cpu", torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, res = rollout.tick(traj, s, cfg, 0.01, 3, None)
    spans = tick_spans.program_spans(prof.profiler.kineto_results.events())
    assert len(spans) == 1
    _check_tick_tree(next(iter(spans.values())), int(res.sqp_iters.max()),
                     full_on_card=False)


def test_span_is_the_shared_noop_without_a_profiler():
    """With no profiler recording every span is one shared no-op object;
    under one it is a new record on the host's timeline, not a user
    annotation (which the profiler mirrors on the device's timeline)."""
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("up.a"), profiling.span("up.b")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = profiling.span("up.c")
        assert inside is not a
        with inside:
            torch.ones(3).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "up.c"]
    assert ev.device_type() == torch.autograd.DeviceType.CPU
    assert not ev.is_user_annotation()
    assert profiling.span("up.d") is a


@pytest.mark.parametrize("condense", [True, False], ids=["condensed", "full"])
@pytest.mark.parametrize("cap", [1, 3])
def test_host_reads_count_the_early_exit_checks(condense, cap):
    """A tick adds to `host_reads` one read per early-exit check its
    relinearisation loop made and nothing else on the CPU (where K6's twin
    runs, whose size needs no nonzero counts, and adaptive rho is off)."""
    cfg = MPCConfig(qp_condense=condense)
    traj, s = _fleet(cfg, 3, "cpu", torch.float64)
    before = dict(profiling.host_reads)
    _, _, res = rollout.tick(traj, s, cfg, 0.01, cap, None)
    grew = {k: profiling.host_reads[k] - before[k] for k in before}
    passes = int(res.sqp_iters.max())
    assert 1 <= passes <= cap
    assert grew == {"mpc_step.done": _early_exit_checks(passes, cap),
                    "nonzero_counts": 0, "solve_qp.done": 0,
                    "solve_qp.adapt": 0}


def _small_qp(B=3, n=6, m=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    M = rnd(B, n, n)
    P = M @ M.transpose(1, 2) + torch.eye(n, dtype=torch.float64)
    A = rnd(B, m, n)
    l, u = -rnd(B, m).abs() - 0.1, rnd(B, m).abs() + 0.1
    l[:, 0] = u[:, 0]          # an equality row
    return P, rnd(B, n), A, l, u


def test_nonzero_counts_and_adaptive_rho_reads_are_counted(monkeypatch):
    """`nonzero_counts` is one read; with adaptive rho `solve_qp` reads
    `done` after every segment of iterations and whether to adapt after
    every segment that did not finish the batch; `reset_host_reads` zeroes
    every site."""
    P, q, A, l, u = _small_qp()
    d = admm_qp.setup_qp(P, q, A, l, u).data
    before = dict(profiling.host_reads)
    assert kadmm.nonzero_counts(d) == (int((d.A != 0).sum((1, 2)).max()),
                                       int((d.P != 0).sum((1, 2)).max()))
    assert profiling.host_reads["nonzero_counts"] \
        == before["nonzero_counts"] + 1

    segments = []
    run = kadmm.admm_iterations
    monkeypatch.setattr(kadmm, "admm_iterations",
                        lambda *a, **k: segments.append(1) or run(*a, **k))
    before = dict(profiling.host_reads)
    sol = admm_qp.solve_qp(P, q, A, l, u, adaptive_rho=True,
                           adaptive_rho_interval=5, max_iter=400,
                           polish=False)
    assert len(segments) >= 2 and bool(torch.isfinite(sol.x).all())
    done = profiling.host_reads["solve_qp.done"] - before["solve_qp.done"]
    adapt = profiling.host_reads["solve_qp.adapt"] - before["solve_qp.adapt"]
    assert done == len(segments)
    assert len(segments) - 1 <= adapt <= len(segments)
    assert profiling.host_reads["mpc_step.done"] == before["mpc_step.done"]

    kept = dict(profiling.host_reads)
    try:
        profiling.reset_host_reads()
        assert set(profiling.host_reads.values()) == {0}
    finally:
        profiling.host_reads.update(kept)


@pytest.mark.parametrize("mode", ["yawshare", "xyz", "xy"])
def test_construct_map_spans(mode):
    """`construct_map` in each mode: `up.construct_map` holds the buckets,
    the nearest-z seeds (not in mode xy, which has none) and the sweep, in
    that order."""
    cfg = MapConfig(map_size_x=0.6, map_size_y=0.6, xy_resolution=0.1,
                    yaw_resolution=1.1, iter_num=1)
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.3, 0.3, (400, 2))
    pts = np.concatenate([xy, 0.1 * xy[:, :1]], axis=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.construct_map(pts, cfg, mode=mode, device="cpu")
    spans = tick_spans.program_spans(prof.profiler.kineto_results.events())
    (top,) = _tree(next(iter(spans.values())))
    assert top[0] == "up.construct_map"
    seeds = [] if mode == "xy" else ["up.construct_map.seeds"]
    assert _names(top[1]) == ["up.construct_map.buckets", *seeds,
                              "up.construct_map.sweep"]


class Ev(NamedTuple):
    """A profiler event as `tick_spans.device_time_by_span` reads it."""
    n: str
    device: bool
    a: int
    b: int
    corr: int = 0
    thread: int = 1
    annotation: bool = False

    def name(self): return self.n
    def start_ns(self): return self.a
    def end_ns(self): return self.b
    def start_thread_id(self): return self.thread
    def correlation_id(self): return self.corr
    def is_user_annotation(self): return self.annotation

    def device_type(self):
        dt = torch.autograd.DeviceType
        return dt.CUDA if self.device else dt.CPU


def _events():
    return [
        Ev("up.a", False, 0, 100, corr=1),
        Ev("up.a.b", False, 10, 40, corr=2),
        Ev("up.c", False, 0, 50, corr=3, thread=2),   # another thread's
        Ev("aten::mul", False, 4, 9, corr=4),
        Ev("cudaLaunchKernel", False, 5, 6, corr=11),     # in up.a
        Ev("cudaLaunchKernel", False, 20, 21, corr=12),   # in up.a.b
        Ev("cudaMemcpyAsync", False, 30, 31, corr=14),    # in up.a.b
        Ev("cudaLaunchKernel", False, 150, 151, corr=13),  # in no span
        Ev("cudaLaunchKernel", False, 40, 41, corr=15),   # up.a.b has ended
        Ev("k1", True, 60, 67, corr=11),
        Ev("k2", True, 62, 65, corr=12),                  # overlaps k1
        Ev("Memcpy DtoH", True, 70, 71, corr=14),
        Ev("k3", True, 160, 162, corr=13),
        Ev("k4", True, 200, 204, corr=15),
        # a device-side mirror of a user annotation, whose id is also a
        # runtime call's
        Ev("bench_unit", True, 0, 300, corr=12, annotation=True),
    ]


def test_device_time_by_span_partitions_the_device_time():
    """Each operation's time goes to the innermost span of its launching
    thread at the launch, "" outside every span; mirrors count nowhere;
    the spans' seconds sum to the operations' device time."""
    got = tick_spans.device_time_by_span(_events())
    want = {"up.a": 7e-9 + 4e-9, "up.a.b": 3e-9 + 1e-9, "": 2e-9}
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) < 1e-15, k
    device = sum((e.b - e.a) * 1e-9 for e in _events()
                 if e.device and not e.annotation)
    assert abs(sum(got.values()) - device) < 1e-15


def test_innermost_spans_at_ordered_times():
    spans = [(0, 100, "a"), (10, 40, "b"), (15, 20, "c"), (50, 60, "d")]
    times = [-1, 0, 12, 15, 20, 39, 40, 55, 60, 100, 120]
    assert tick_spans.innermost_spans(spans, times) == [
        "", "a", "b", "c", "b", "b", "a", "d", "a", "", ""]


@pytest.mark.cuda
@pytest.mark.parametrize("condense", [True, False], ids=["condensed", "full"])
def test_tick_reads_and_device_time_by_span_on_card(card, condense):
    """One float32 tick of 512 lanes on the card: every synchronising read
    PyTorch's sync debug mode reports from the counted sites is one count
    of `host_reads` (early-exit checks, and on the full QP one nonzero
    count a pass); under the profiler the spans nest as on the CPU, K6's
    device time is `up.qp.admm`'s own and K7's `up.qp.ruiz`'s, every
    operation is launched inside `up.tick`, no span has a mirror on the
    device's timeline, and the mirror of a `record_function` around the
    tick counts under no span."""
    cfg = MPCConfig(qp_condense=condense)
    traj, s = _fleet(cfg, 512, card, torch.float32)
    s, _, _ = rollout.tick(traj, s, cfg, 0.01, 3, None)   # builds K6
    torch.cuda.synchronize()

    before = dict(profiling.host_reads)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s2, _, res = rollout.tick(traj, s, cfg, 0.01, 3, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    grew = {k: profiling.host_reads[k] - before[k] for k in before}
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    counted = [w for w in syncs if w.filename == profiling.__file__]
    others = sorted({f"{w.filename}:{w.lineno}" for w in syncs
                     if w.filename != profiling.__file__})
    print(f"counted {len(counted)}, by site {grew}; other synchronising "
          f"calls: {others}")
    passes = int(res.sqp_iters.max())
    assert len(counted) == sum(grew.values())
    assert grew["mpc_step.done"] == _early_exit_checks(passes, 3)
    assert grew["nonzero_counts"] == (0 if condense else passes)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a user annotation, which the profiler mirrors on the device
        with record_function("outer"):
            _, _, res = rollout.tick(traj, s2, cfg, 0.01, 3, None)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    spans = tick_spans.program_spans(events)
    _check_tick_tree(spans[max(spans, key=lambda t: len(spans[t]))],
                     int(res.sqp_iters.max()), full_on_card=not condense)
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in events
           if e.device_type() == cuda and e.name() != "outer"]
    assert not [e for e in ops if e.name().startswith("up.")]
    k6 = sum(e.end_ns() - e.start_ns() for e in ops
             if "::admm_" in e.name() and "_kernel" in e.name()) * 1e-9
    by_span = tick_spans.device_time_by_span(events)
    print({k: round(v * 1e3, 4) for k, v in sorted(by_span.items())})
    assert k6 > 0 and abs(by_span["up.qp.admm"] - k6) <= 0.01 * k6
    k7 = sum(e.end_ns() - e.start_ns() for e in ops
             if "ruiz_kernel" in e.name()) * 1e-9
    assert k7 > 0 and abs(by_span["up.qp.ruiz"] - k7) <= 0.01 * k7
    assert by_span.get("", 0.0) == 0.0
    device = sum(e.end_ns() - e.start_ns() for e in ops) * 1e-9
    assert abs(sum(by_span.values()) - device) <= 1e-6 * device
