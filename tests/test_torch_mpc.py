"""Port parity of the tracking controller's pieces with the JAX package
(f64, CPU): the wire round trip and the figure-eight, the ADMM QP solver
with each of its options, the QP assembly, yaw smoothing and `mpc_step`.
Inputs come from a numpy seed; each test states its tolerance."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.config import MPCConfig as JMPCConfig
from uneven_planner_tpu.minco import minco as jminco
from uneven_planner_tpu.minco.traj import SE2Traj as JSE2Traj
from uneven_planner_tpu.mpc import tracker as jtracker
from uneven_planner_tpu.mpc import traj_msg as jmsg
from uneven_planner_tpu.solver import admm_qp as jadmm
from uneven_planner_tpu_torch import convert
from uneven_planner_tpu_torch.config import MPCConfig, scene_config
from uneven_planner_tpu_torch.kernels import admm as kadmm
from uneven_planner_tpu_torch.mpc import tracker, traj_msg
from uneven_planner_tpu_torch.solver import admm_qp

from torch_parity import CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t = torch.tensor


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """The CPU loops of these tests are thousands of tiny tensor operations,
    where PyTorch's thread pool only adds hand-off cost (4x on a busy
    machine): run them on one thread and put the setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _each(fn, *batched):
    """fn on every lane of the numpy inputs, as jax arrays."""
    return [fn(*(jnp.asarray(a[b]) for a in batched))
            for b in range(batched[0].shape[0])]


def _lane_max(got, want):
    """max |got[b] - want[b]| over lanes; `want` a list of jax arrays."""
    return max(float(np.abs(got[b].numpy() - np.asarray(w)).max())
               for b, w in enumerate(want))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_mpc_config_is_a_copy_of_the_jax_package():
    a, b = dataclasses.asdict(JMPCConfig()), dataclasses.asdict(MPCConfig())
    assert a == b
    for prop in ("max_comega", "max_csteer", "max_cv"):
        assert getattr(JMPCConfig(), prop) == getattr(MPCConfig(), prop)
    assert scene_config("hill").mpc == MPCConfig()


# ---------------------------------------------------------------------------
# wire format and the figure-eight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_vel,n_pieces", [(0.5, 16), (0.4, 8)])
def test_figure_eight_matches_jax(max_vel, n_pieces):
    want = jmsg.figure_eight(max_vel, n_pieces=n_pieces)
    got = traj_msg.figure_eight(max_vel, n_pieces=n_pieces, device=CPU)
    assert got.c_xy.shape == (1, n_pieces, 6, 2)
    assert got.c_xy.dtype == torch.float64
    for g, w in zip(got, want):           # same waypoints, same solve: 1e-12
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=1e-12)
    f32 = traj_msg.figure_eight(max_vel, n_pieces=n_pieces,
                                dtype=torch.float32, device=CPU)
    assert f32.c_xy.dtype == torch.float32
    np.testing.assert_allclose(f32.c_xy.double().numpy(),
                               got.c_xy.numpy(), atol=1e-4)


def _random_trajs(rng, B, N, zero_boundary):
    inner = rng.normal(size=(B, N - 1, 2))
    ts = rng.uniform(0.5, 1.2, size=(B, N))
    head = rng.normal(size=(B, 3, 2))
    tail = rng.normal(size=(B, 3, 2))
    if zero_boundary:
        head[:, 1:] = 0.0
        tail[:, 1:] = 0.0
    inner_yaw = rng.normal(size=(B, N - 1, 1))
    zero = np.zeros((B, 3, 1))
    return inner, ts, head, tail, inner_yaw, zero


@pytest.mark.parametrize("zero_boundary", [True, False])
def test_msg_round_trip_matches_jax(zero_boundary):
    """msg_from_traj / traj_from_msg lane for lane (1e-10).  With zero
    boundary velocity and acceleration the round trip is exact; with a
    nonzero start velocity it is not, because the message zeroes init_v and
    init_a, and the port keeps that behaviour."""
    from uneven_planner_tpu_torch.minco import minco
    from uneven_planner_tpu_torch.minco.traj import SE2Traj
    rng = np.random.default_rng(0)
    B, N = 3, 6
    inner, ts, head, tail, inner_yaw, zero = _random_trajs(rng, B, N,
                                                           zero_boundary)
    jtrajs = [JSE2Traj(jminco.generate(i, s, h, tl), s,
                       jminco.generate(iy, s, z, z), s)
              for i, s, h, tl, iy, z in zip(*map(
                  jnp.asarray, (inner, ts, head, tail, inner_yaw, zero)))]
    traj = SE2Traj(minco.generate(t(inner), t(ts), t(head), t(tail)), t(ts),
                   minco.generate(t(inner_yaw), t(ts), t(zero), t(zero)),
                   t(ts))
    jmsgs = [jmsg.msg_from_traj(q) for q in jtrajs]
    msg = traj_msg.msg_from_traj(traj)
    for name in traj_msg.SE2TrajMsg._fields:
        assert _lane_max(getattr(msg, name),
                         [getattr(m, name) for m in jmsgs]) < 1e-10, name
    assert not msg.init_v.any() and not msg.init_a.any()
    back = traj_msg.traj_from_msg(msg)
    jback = [jmsg.traj_from_msg(m) for m in jmsgs]
    assert _lane_max(back.c_xy, [b.c_xy for b in jback]) < 1e-10
    assert _lane_max(back.c_yaw, [b.c_yaw for b in jback]) < 1e-10
    gap = float((back.c_xy - traj.c_xy).abs().max())
    assert (gap < 1e-8) if zero_boundary else (gap > 1e-3), gap
    # the carrier takes the JAX package's message as it is
    carried = convert.traj_msg_from_numpy(
        jax.tree.map(np.asarray, jmsgs[1]), device=CPU)
    np.testing.assert_allclose(carried.pos_pts[0].numpy(),
                               msg.pos_pts[1].numpy(), atol=1e-10)


# ---------------------------------------------------------------------------
# ADMM QP
# ---------------------------------------------------------------------------

def _box_qps(seed, B, n, m, q_scale=3.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        L = rng.normal(size=(n, n))
        out.append((L @ L.T + n * np.eye(n), rng.normal(size=n) * q_scale,
                    rng.normal(size=(m, n)),
                    -np.abs(rng.normal(size=m)) - 0.1,
                    np.abs(rng.normal(size=m)) + 0.1))
    return [np.stack(a) for a in zip(*out)]


def _equality_qps(seed, B, n, m):
    P, q, A, _, _ = _box_qps(seed, B, n, m, q_scale=1.0)
    b = np.random.default_rng(seed + 1).normal(size=(B, m))
    return [P, q, A, b, b.copy()]


def _badly_scaled_qps(seed, B, n, m):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        scales = 10.0 ** rng.uniform(-3, 3, size=n)
        L = rng.normal(size=(n, n)) * scales[None, :]
        out.append((L.T @ L + 1e-3 * np.diag(scales ** 2) + 1e-6 * np.eye(n),
                    rng.normal(size=n) * scales,
                    rng.normal(size=(m, n)) * scales[None, :],
                    -np.abs(rng.normal(size=m)) - 0.1,
                    np.abs(rng.normal(size=m)) + 0.1))
    return [np.stack(a) for a in zip(*out)]


def _assert_solution_matches(got, want, tol=1e-8):
    """x and y within `tol` of the JAX package's, equal iteration counts and
    converged flags, lane for lane (the two sum in different orders at
    1e-16 relative; neither count sits at a threshold in these cases)."""
    assert got.iters.tolist() == [int(w.iters) for w in want]
    assert got.converged.tolist() == [bool(w.converged) for w in want]
    assert _lane_max(got.x, [w.x for w in want]) < tol
    assert _lane_max(got.y, [w.y for w in want]) < tol
    assert _lane_max(got.r_prim, [w.r_prim for w in want]) < tol
    assert _lane_max(got.r_dual, [w.r_dual for w in want]) < tol


QP_CASES = {
    # the QPs of tests/test_mpc.py:18-105, three lanes each
    "equality": (_equality_qps(0, 3, 12, 5),
                 dict(eps_abs=1e-10, eps_rel=1e-10, max_iter=20000)),
    "box": (_box_qps(1, 3, 10, 16),
            dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000)),
    "box_plain": (_box_qps(1, 3, 10, 16),
                  dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000,
                       ruiz=False, adaptive_rho=False, polish=False)),
    "box_no_polish": (_box_qps(1, 3, 10, 16),
                      dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000,
                           polish=False)),
    "box_fixed_rho": (_box_qps(1, 3, 10, 16),
                      dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000,
                           adaptive_rho=False)),
    "box_fixed_iters": (_box_qps(1, 3, 10, 16),
                        dict(max_iter=2000, adaptive_rho=False, polish=False,
                             fixed_iters=60)),
    "box_interval_10": (_box_qps(2, 3, 10, 16),
                        dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=5000,
                             adaptive_rho_interval=10, fixed_iters=95)),
    "badly_scaled": (_badly_scaled_qps(7, 2, 14, 20),
                     dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)),
    "polish": (_box_qps(11, 3, 10, 14),
               dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000)),
}


@pytest.mark.parametrize("case", sorted(QP_CASES))
def test_solve_qp_matches_jax(case):
    qp, kw = QP_CASES[case]
    want = _each(jax.jit(lambda *a: jadmm.solve_qp(*a, **kw)), *qp)
    got = admm_qp.solve_qp(*map(t, qp), **kw)
    # the badly scaled QP amplifies the summation-order noise through
    # factors conditioned at 1e6
    _assert_solution_matches(got, want,
                             tol=1e-6 if case == "badly_scaled" else 1e-8)
    if "fixed_iters" not in kw:
        stat, prim, comp = admm_qp.kkt_residuals(*map(t, qp), got.x, got.y)
        assert float(stat.max()) < 1e-5 and float(prim.max()) < 1e-6 \
            and float(comp.max()) < 1e-4


def test_solve_qp_warm_start_matches_jax():
    qp = _box_qps(3, 3, 10, 16)
    rng = np.random.default_rng(4)
    x0, y0 = rng.normal(size=(3, 10)), rng.normal(size=(3, 16))
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=5000, polish=False,
              adaptive_rho=False)
    want = _each(jax.jit(lambda P, q, A, l, u, x, y: jadmm.solve_qp(
        P, q, A, l, u, x0=x, y0=y, **kw)), *qp, x0, y0)
    got = admm_qp.solve_qp(*map(t, qp), x0=t(x0), y0=t(y0), **kw)
    _assert_solution_matches(got, want)
    cold = admm_qp.solve_qp(*map(t, qp), **kw)
    warm = admm_qp.solve_qp(*map(t, qp), x0=cold.x, y0=cold.y, **kw)
    assert (warm.iters < cold.iters).all()


def test_solve_qp_reproduces_the_dumped_tracking_qp():
    """The condensed tracking QP of QP_DUMP_r05.json (n = 60, m = 118) with
    the controller's settings: the JAX package's solution within 1e-8 and
    the dumped f64 active-set optimum within the dump's own gap."""
    with open(os.path.join(REPO, "QP_DUMP_r05.json")) as f:
        d = json.load(f)
    qp = [np.asarray(d[k], np.float64)[None] for k in "PqAlu"]
    cfg = MPCConfig()
    kw = dict(rho=cfg.qp_rho, sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
              eps_abs=cfg.qp_abs_tol, eps_rel=cfg.qp_rel_tol,
              max_iter=cfg.qp_max_iter, polish=cfg.qp_polish,
              adaptive_rho=cfg.qp_adaptive_rho,
              fixed_iters=cfg.qp_scan_iters)
    want = _each(jax.jit(lambda *a: jadmm.solve_qp(*a, **kw)), *qp)
    got = admm_qp.solve_qp(*convert.qp_from_numpy(*[a[0] for a in qp],
                                                  device=CPU), **kw)
    _assert_solution_matches(got, want)
    gap = np.abs(got.x[0].numpy() - np.asarray(d["x_activeset_f64"])).max()
    assert gap < 1e-5, gap
    sol = convert.qp_solution_from_numpy(jax.tree.map(np.asarray, want[0]),
                                         device=CPU)
    assert sol.x.shape == (1, 60) and sol.iters.tolist() == got.iters.tolist()


def test_ruiz_equilibrate_matches_jax():
    qp = _badly_scaled_qps(5, 3, 14, 20)
    want = _each(jadmm.ruiz_equilibrate, *qp)
    got = admm_qp.ruiz_equilibrate(*map(t, qp))
    for i in range(8):                                   # 1e-12 relative
        for b in range(3):
            np.testing.assert_allclose(got[i][b].numpy(),
                                       np.asarray(want[b][i]), rtol=1e-12,
                                       atol=1e-300)


def test_kkt_residuals_and_polish_match_jax():
    qp = _box_qps(6, 3, 10, 14)
    rough = admm_qp.solve_qp(*map(t, qp), eps_abs=1e-4, eps_rel=1e-4,
                             polish=False, adaptive_rho=False)
    x, y = rough.x.numpy(), rough.y.numpy()
    want = _each(jadmm.kkt_residuals, *qp, x, y)
    got = admm_qp.kkt_residuals(*map(t, qp), rough.x, rough.y)
    for i in range(3):
        assert _lane_max(got[i], [w[i] for w in want]) < 1e-12
    wp = _each(jadmm._polish, *qp, x, y)
    gx, gy = admm_qp._polish(*map(t, qp), rough.x, rough.y)
    assert _lane_max(gx, [w[0] for w in wp]) < 1e-9
    assert _lane_max(gy, [w[1] for w in wp]) < 1e-9
    stat, prim, _ = admm_qp.kkt_residuals(*map(t, qp), gx, gy)
    assert float(stat.max()) < 1e-9 and float(prim.max()) < 1e-9


def test_bad_lane_does_not_stop_the_batch():
    """An indefinite or non-finite lane gets a NaN inverse and a NaN
    solution and raises nothing; the other lanes are as without it; polish
    keeps the unpolished point where its result is not finite."""
    qp = [t(a) for a in _box_qps(8, 3, 8, 10)]
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=300, adaptive_rho=False)
    good = admm_qp.solve_qp(*qp, **kw)
    bad = [a.clone() for a in qp]
    bad[0][1] = -bad[0][1] * 50.0          # lane 1: M not positive definite
    bad[0][2, 0, 0] = float("nan")         # lane 2: not finite
    M = torch.stack([torch.eye(4, dtype=torch.float64),
                     -torch.eye(4, dtype=torch.float64),
                     torch.full((4, 4), float("nan"), dtype=torch.float64)])
    inv = admm_qp._spd_inverse(M)
    assert torch.equal(inv[0], torch.eye(4, dtype=torch.float64))
    assert inv[1:].isnan().all()
    got = admm_qp.solve_qp(*bad, **kw)
    torch.testing.assert_close(got.x[0], good.x[0], rtol=0, atol=0)
    assert got.x[1:].isnan().all() and got.iters[1:].tolist() == [300, 300]
    assert not got.converged[1:].any() and bool(got.converged[0])


@pytest.mark.parametrize("split", [(25, 375), (1, 399), (400, 0)])
def test_admm_iterations_twin_is_resumable(split):
    """The state round-trips: n_iters split in two equals one call, bit for
    bit; a done lane is frozen; `it` counts per lane."""
    P, q, A, l, u = [t(a) for a in _box_qps(9, 4, 8, 12)]
    l[3], u[3] = -1e3, 1e3       # lane 3: slack box, converges at once
    rho = torch.full((4, 12), 0.1, dtype=torch.float64)
    M = P + 1e-6 * torch.eye(8, dtype=torch.float64) \
        + (A.transpose(1, 2) * rho[:, None, :]) @ A
    one = torch.ones
    d = kadmm.ADMMData(P, q, A, l, u, rho, admm_qp._spd_inverse(M),
                       one((4, 8), dtype=torch.float64),
                       one((4, 12), dtype=torch.float64),
                       one((4,), dtype=torch.float64))
    z0 = torch.zeros((4, 12), dtype=torch.float64)
    s0 = kadmm.initial_state(torch.zeros((4, 8), dtype=torch.float64), z0,
                             z0.clone())
    kw = dict(sigma=1e-6, alpha=1.6, eps_abs=1e-6, eps_rel=1e-6,
              max_iter=300)
    whole = kadmm.admm_iterations(d, s0, n_iters=400, **kw)
    part = kadmm.admm_iterations(d, s0, n_iters=split[0], **kw)
    part = kadmm.admm_iterations(d, part, n_iters=split[1], **kw)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    assert whole.done.all() and (whole.it <= 300).all()
    assert whole.it[3] == whole.it.min() < whole.it.max() == 300
    assert s0.it.tolist() == [0, 0, 0, 0]          # the input state is kept
    assert kadmm.launches["admm_iterations"] == 0  # the CPU runs the twin


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _tick_inputs(seed, B, T):
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(B, 3)) * 0.3
    output = np.stack([rng.uniform(0.2, 0.5, (B, T)),
                       rng.normal(size=(B, T)) * 0.1], axis=1)
    xref = np.cumsum(rng.uniform(0.0, 0.01, (B, 3, T)), axis=-1)
    dref = rng.normal(size=(B, 2, T)) * 0.01
    return state, output, xref, dref


@pytest.mark.parametrize("model", [tracker.DIFF, tracker.ACKER])
def test_linearize_and_state_trans_match_jax(model):
    jc, tc = JMPCConfig(model_type=model), MPCConfig(model_type=model)
    rng = np.random.default_rng(model)
    th, vx, de = rng.normal(size=(3, 5))
    want = _each(lambda a, b, c: jtracker.linearize(a, b, c, jc), th, vx, de)
    got = tracker.linearize(t(th), t(vx), t(de), tc)
    for i in range(3):                                    # 1e-12
        assert _lane_max(got[i], [w[i] for w in want]) < 1e-12
    state, u = rng.normal(size=(5, 3)), rng.normal(size=(5, 2))
    assert _lane_max(tracker.state_trans(t(state), t(u), tc),
                     _each(lambda s, v: jtracker.state_trans(s, v, jc),
                           state, u)) < 1e-12
    # A x + B u + C is the nonlinear step at the linearization point
    A, B, C = tracker.linearize(t(np.array([0.7])), t(np.array([0.4])),
                                t(np.array([0.2])), tc)
    x, v = t(np.array([[1.0, 2.0, 0.7]])), t(np.array([[0.4, 0.2]]))
    lin = (A @ x[..., None])[..., 0] + (B @ v[..., None])[..., 0] + C
    torch.testing.assert_close(lin, tracker.state_trans(x, v, tc),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("model", [tracker.DIFF, tracker.ACKER])
@pytest.mark.parametrize("delay", [0, 2])
def test_qp_assembly_matches_jax(model, delay):
    kw = dict(model_type=model, delay_num=delay, predict_steps=12)
    jc, tc = JMPCConfig(**kw), MPCConfig(**kw)
    state, output, xref, dref = _tick_inputs(3, 3, 12)
    jx = _each(lambda s, o: jtracker.predict_motion(s, o, jc), state, output)
    xbar = tracker.predict_motion(t(state), t(output), tc)
    assert _lane_max(xbar, jx) < 1e-12
    for name in ("assemble_qp", "assemble_qp_condensed"):
        want = [getattr(jtracker, name)(jx[b], *(jnp.asarray(a[b]) for a in
                                                 (output, xref, dref)), jc)
                for b in range(3)]
        got = getattr(tracker, name)(xbar, t(output), t(xref), t(dref), tc)
        for i in range(5):                                # 1e-10
            assert _lane_max(got[i], [w[i] for w in want]) < 1e-10, (name, i)
    H = 12 - delay
    Pu, qu = tracker._input_block(tc, H, t(dref))
    wPu, _ = jtracker._input_block(jc, H, jnp.asarray(dref[0]), jnp.float64)
    np.testing.assert_array_equal(Pu.numpy(), np.asarray(wPu))
    assert _lane_max(qu, _each(lambda d: jtracker._input_block(
        jc, H, d, jnp.float64)[1], dref)) == 0.0


@pytest.mark.parametrize("model", [tracker.DIFF, tracker.ACKER])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_predict_motion_equals_repeated_state_trans(model, dtype):
    """`predict_motion` reorders the work (heading recursion first, position
    increments for all steps at once) without changing any operation: bit
    for bit the step-by-step rollout, inputs beyond the clips included."""
    cfg = MPCConfig(model_type=model)
    rng = np.random.default_rng(model)
    state = torch.tensor(rng.normal(size=(5, 3)), dtype=dtype)
    output = torch.tensor(rng.normal(size=(5, 2, 30)), dtype=dtype)
    ref = [state]
    for k in range(30):
        ref.append(tracker.state_trans(ref[-1], output[:, :, k], cfg))
    assert torch.equal(tracker.predict_motion(state, output, cfg),
                       torch.stack(ref, dim=1))


def test_smooth_yaw_matches_jax_on_the_wrap_cases():
    yaws = np.array([[3.0, 3.2, 3.4, -2.9, -2.7],        # crosses +pi
                     [-3.0, -3.2, 2.9, 2.7, 2.5],        # crosses -pi
                     [0.1, 0.2, 0.1, 0.0, -0.1],         # no wrap
                     [6.5, 12.9, -6.1, 0.3, 9.6]])       # several turns
    now = np.array([2.9, -2.8, 0.0, 7.0])
    xref = np.zeros((4, 3, 5))
    xref[:, 2] = yaws
    xref[:, :2] = np.random.default_rng(0).normal(size=(4, 2, 5))
    want = _each(jtracker.smooth_yaw, xref, now)
    got = tracker.smooth_yaw(t(xref), t(now))
    assert _lane_max(got, want) < 1e-12
    np.testing.assert_allclose(np.sin(got[:, 2].numpy()), np.sin(yaws),
                               atol=1e-12)
    assert (np.abs(np.diff(got[:3, 2].numpy(), axis=1)) < np.pi / 2).all()
    d = np.array([np.pi / 2, -np.pi / 2, np.pi / 2 + 2 * np.pi, 0.0, 20.0])
    np.testing.assert_allclose(tracker._wrap_towards(t(d)).numpy(),
                               np.asarray(jtracker._wrap_towards(
                                   jnp.asarray(d))), atol=1e-14)


@pytest.mark.parametrize("model,delay", [(tracker.DIFF, 0), (tracker.DIFF, 2),
                                         (tracker.ACKER, 0),
                                         (tracker.ACKER, 2)])
def test_mpc_step_matches_jax(model, delay):
    """One tick, three lanes, both models, with and without input delay:
    outputs and delay buffers within 1e-9, equal QP and pass counts."""
    kw = dict(model_type=model, delay_num=delay, predict_steps=12)
    jc, tc = JMPCConfig(**kw), MPCConfig(**kw)
    state, output, xref, dref = _tick_inputs(5 + delay, 3, 12)
    buff = np.random.default_rng(1).normal(size=(3, max(delay, 1), 2)) * 0.1
    want = _each(jax.jit(lambda s, x, d, o, b: jtracker.mpc_step(
        s, x, d, o, b, jc, max_sqp_iter=3)), state, xref, dref, output, buff)
    got = tracker.mpc_step(t(state), t(xref), t(dref), t(output), t(buff),
                           tc, max_sqp_iter=3)
    assert got.qp_iters.tolist() == [int(w.qp_iters) for w in want]
    assert got.sqp_iters.tolist() == [int(w.sqp_iters) for w in want]
    for name in ("cmd", "output", "output_buff", "du"):
        assert _lane_max(getattr(got, name),
                         [getattr(w, name) for w in want]) < 1e-9, name
    assert (got.qp_iters_max <= got.qp_iters).all()
    assert got.qp_failed.tolist() == [0, 0, 0]


def test_mpc_step_full_qp_matches_jax():
    kw = dict(qp_condense=False, predict_steps=8, qp_scan_iters=150)
    jc, tc = JMPCConfig(**kw), MPCConfig(**kw)
    state, output, xref, dref = _tick_inputs(9, 2, 8)
    buff = np.zeros((2, 1, 2))
    want = _each(jax.jit(lambda s, x, d, o, b: jtracker.mpc_step(
        s, x, d, o, b, jc, max_sqp_iter=2)), state, xref, dref, output, buff)
    got = tracker.mpc_step(t(state), t(xref), t(dref), t(output), t(buff),
                           tc, max_sqp_iter=2)
    assert got.qp_iters.tolist() == [int(w.qp_iters) for w in want]
    assert _lane_max(got.output, [w.output for w in want]) < 1e-9


def test_mpc_step_early_exit_freezes_done_lanes():
    """A lane already at its fixed point leaves the relinearization loop
    after one pass while the others go on; its output stays as it was."""
    jc, tc = JMPCConfig(predict_steps=10), MPCConfig(predict_steps=10)
    state, output, xref, dref = _tick_inputs(2, 3, 10)
    buff = np.zeros((3, 1, 2))
    first = tracker.mpc_step(t(state), t(xref), t(dref), t(output), t(buff),
                             dataclasses.replace(tc, du_threshold=0.0),
                             max_sqp_iter=6)
    settled = first.output.numpy()
    output[0] = settled[0]                    # lane 0 starts where it ends
    loose = dict(du_threshold=0.05)
    jl, tl = (dataclasses.replace(c, **loose) for c in (jc, tc))
    want = _each(jax.jit(lambda s, x, d, o, b: jtracker.mpc_step(
        s, x, d, o, b, jl, max_sqp_iter=3)), state, xref, dref, output, buff)
    got = tracker.mpc_step(t(state), t(xref), t(dref), t(output), t(buff),
                           tl, max_sqp_iter=3)
    assert got.sqp_iters.tolist() == [int(w.sqp_iters) for w in want]
    assert got.sqp_iters[0] == 1 and got.sqp_iters.max() > 1
    assert _lane_max(got.output, [w.output for w in want]) < 1e-9


def test_mpc_step_keeps_previous_output_on_solver_failure():
    """A non-finite QP solution must not poison the carried output: the
    failing lane keeps the previous tick's inputs (the reference's
    OSQP-failure behaviour, mpc.cpp:526-539), the other lane is solved."""
    cfg = MPCConfig()
    T, d = cfg.predict_steps, cfg.delay_num
    prev = torch.tensor(np.tile([[0.3], [0.1]], (2, 1, T)),
                        dtype=torch.float32)
    buff = torch.zeros((2, max(d, 1), 2), dtype=torch.float32)
    state = torch.zeros((2, 3), dtype=torch.float32)
    refs = torch.zeros((2, 3, T), dtype=torch.float32)
    refs[0] = float("nan")                  # poisons q -> sol.x of lane 0
    refs[1, 0] = torch.arange(T) * 0.006
    res = tracker.mpc_step(state, refs, torch.zeros((2, 2, T)), prev, buff,
                           cfg, max_sqp_iter=1)
    assert torch.isfinite(res.output).all()
    torch.testing.assert_close(res.output[0], prev[0], rtol=0, atol=0)
    torch.testing.assert_close(res.cmd[0], prev[0, :, d], rtol=0, atol=0)
    assert res.qp_failed.tolist() == [1, 0]
    assert (res.output[1] - prev[1]).abs().max() > 1e-3


def test_get_ref_points_matches_jax_up_to_the_end_of_the_trajectory():
    """Per-lane times, including the ticks near the goal where every sample
    is clamped to the duration and `locate_piece` meets the end of the last
    piece (searchsorted side="right")."""
    jc, tc = JMPCConfig(), MPCConfig()
    jf8 = jmsg.figure_eight(0.5)
    f8 = traj_msg.figure_eight(0.5, device=CPU)
    dur = float(f8.total_duration[0])
    t_now = np.array([0.0, 1.234, dur - 0.3, dur, dur + 0.5, dur + 1.5])
    from uneven_planner_tpu_torch.minco.traj import expand_traj
    lanes = expand_traj(f8, 6)
    refs, at_goal = tracker.get_ref_points(lanes, t(t_now), tc)
    want = [jtracker.get_ref_points(jf8, jnp.asarray(x), jc) for x in t_now]
    assert _lane_max(refs, [w[0] for w in want]) < 1e-9
    assert at_goal.tolist() == [bool(w[1]) for w in want]
    assert at_goal.tolist() == [False] * 5 + [True]
    from uneven_planner_tpu_torch.minco import minco
    idx, s = minco.locate_piece(torch.cumsum(f8.ts_xy, 1),
                                t(np.array([[dur, dur + 1.0, 0.0]])))
    jidx, js = jminco.locate_piece(jnp.cumsum(jf8.ts_xy),
                                   jnp.asarray([dur, dur + 1.0, 0.0]))
    assert idx[0].tolist() == np.asarray(jidx).tolist() == [15, 15, 0]
    np.testing.assert_allclose(s[0].numpy(), np.asarray(js), atol=1e-12)


# ---------------------------------------------------------------------------
# the gates of the JAX package's own tests, held by the port
# ---------------------------------------------------------------------------

def test_condensed_qp_has_the_full_qp_optimum_f64():
    """The inputs-only condensed QP has the same unique input optimum as the
    full state + input QP (the elimination is exact: the reference QP has
    no state bounds), by the certified f64 active-set oracle on both forms
    as the port assembles them (rtol 1e-6, atol 1e-8)."""
    from uneven_planner_tpu.utils import qp_ref
    rng = np.random.default_rng(7)
    for model in (tracker.DIFF, tracker.ACKER):
        cfg = MPCConfig(model_type=model, predict_steps=12)
        T = cfg.predict_steps
        for _ in range(2):
            curv, v0 = rng.uniform(-0.8, 0.8), rng.uniform(0.2, 0.5)
            yawr = curv * v0 * np.arange(T) * cfg.dt
            xr = np.cumsum(v0 * cfg.dt * np.cos(yawr))
            yr = np.cumsum(v0 * cfg.dt * np.sin(yawr))
            state = t(np.array([[xr[0] + rng.normal() * 0.03,
                                 yr[0] + rng.normal() * 0.03,
                                 yawr[0] + rng.normal() * 0.05]]))
            output = t(np.stack([
                np.full(T, v0) + rng.normal(size=T) * 0.02,
                np.full(T, curv * 0.1) + rng.normal(size=T) * 0.02])[None])
            xref = t(np.stack([xr, yr, yawr])[None])
            dref = torch.zeros_like(xref[:, :2])
            xbar = tracker.predict_motion(state, output, cfg)
            full = [a[0].numpy() for a in tracker.assemble_qp(
                xbar, output, xref, dref, cfg)]
            cond = [a[0].numpy() for a in tracker.assemble_qp_condensed(
                xbar, output, xref, dref, cfg)]
            z_full, _ = qp_ref.solve_qp_f64(*full)
            u_cond, _ = qp_ref.solve_qp_f64(*cond)
            np.testing.assert_allclose(u_cond, z_full[3 * T:], rtol=1e-6,
                                       atol=1e-8)


def test_mpc_golden_control_sequence_parity_f64():
    """The production (f32) path of the port reproduces the tracking QP's
    exact optimum to < 1e-3 max control-sequence error per tick over a
    figure-eight episode at reference settings.  Golden values: the same
    relinearization loop with certified f64 active-set solves of the full
    QP (`utils.qp_ref.solve_qp_f64` of the JAX package)."""
    from uneven_planner_tpu.utils import qp_ref
    from uneven_planner_tpu_torch.minco.traj import se2_state
    from uneven_planner_tpu_torch.sim import rollout
    cfg = MPCConfig()
    f8 = traj_msg.figure_eight(max_vel=0.4, device=CPU)
    T, d = cfg.predict_steps, cfg.delay_num
    H = T - d
    f64 = lambda a: t(np.asarray(a, np.float64)[None])
    f32 = lambda a: t(np.asarray(a, np.float32)[None])

    def mirror_f64(state, xref, dref, output_prev):
        out = np.asarray(output_prev, np.float64)
        for _ in range(3):
            xbar = tracker.predict_motion(f64(state), f64(out), cfg)
            qp = [a[0].numpy() for a in tracker.assemble_qp(
                xbar, f64(out), f64(xref), f64(dref), cfg)]
            z, _ = qp_ref.solve_qp_f64(*qp)
            new = out.copy()
            new[:, d:] = z[3 * H:].reshape(H, 2).T
            du = np.sum(np.abs(new - out))
            out = new
            if du <= cfg.du_threshold:
                break
        return out

    pos, _, _, yaw, _, _ = se2_state(f8, torch.zeros((1, 1)).double())
    state = np.array([float(pos[0, 0, 0]) + 0.05, float(pos[0, 0, 1]) - 0.03,
                      float(yaw[0, 0]) + 0.1])
    output = np.zeros((2, T))
    buff = np.zeros((max(d, 1), 2))
    worst, t_now = 0.0, 0.0
    for _ in range(12):
        refs, _ = tracker.get_ref_points(f8, t(np.array([t_now])), cfg)
        refs = tracker.smooth_yaw(refs, t(state[2:3]))[0].numpy()
        dref = np.zeros_like(refs[:2])
        res = tracker.mpc_step(f32(state), f32(refs), f32(dref), f32(output),
                               f32(buff), cfg, max_sqp_iter=3)
        gold = mirror_f64(state, refs, dref, output)
        worst = max(worst, np.abs(res.output[0].double().numpy() - gold)
                    .max())
        state = rollout.plant_step(f64(state), f64(gold[:, d]), cfg,
                                   0.01)[0].numpy()
        output = gold
        t_now += 0.01
    assert worst < 1e-3, f"max control-sequence error {worst:.2e}"


# ---------------------------------------------------------------------------
# wheel-level actuation and teleoperation (sim/ackermann.py, sim/teleop.py)
# ---------------------------------------------------------------------------

def test_ackermann_wheel_mapping():
    """tests/test_mpc.py:177 on the port, batched over the three commands,
    and each field against the JAX package's (1e-12)."""
    from uneven_planner_tpu.sim import ackermann as jak
    from uneven_planner_tpu_torch.sim import ackermann as ak
    v = np.array([0.02, 0.02, 0.02, -0.01, 0.2])
    steer = np.array([0.3, 0.0, 0.3, -0.5, 2.0])
    stale = np.array([False, False, True, False, False])
    t = torch.tensor
    wc = ak.wheel_commands(t(v), t(steer), t(stale))
    # left turn (positive steer): left is the inside wheel
    assert float(wc.rear_left[0]) < float(wc.rear_right[0])
    assert float(wc.steer_left[0]) > float(wc.steer_right[0]) > 0
    # straight
    np.testing.assert_allclose(float(wc.rear_left[1]),
                               float(wc.rear_right[1]))
    assert float(wc.steer_left[1]) == 0.0
    # dead-man zeroes everything
    assert float(wc.rear_left[2]) == 0.0 and float(wc.steer_left[2]) == 0.0
    want = jax.vmap(jak.wheel_commands)(jnp.asarray(v), jnp.asarray(steer),
                                        jnp.asarray(stale))
    for name in ak.WheelCommand._fields:
        np.testing.assert_allclose(getattr(wc, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-12, err_msg=name)
    # rear-axle pose offset (true_state_pub.py:49-53)
    pose = ak.rear_axle_pose(t([1.0, 2.0, 0.0]))
    np.testing.assert_allclose(pose.numpy(), [0.87, 2.0, 0.0], atol=1e-12)


def test_teleop_state_machine_and_world_tf():
    """tests/test_mpc.py:358 on the port: the key-state machine
    (keyboard_control.py:30-84) and the world->base_footprint transform,
    whose quaternion round-trips the terrain lift's rotation."""
    from uneven_planner_tpu.config import MapConfig as JMapConfig
    from uneven_planner_tpu.sim import ackermann as jak
    from uneven_planner_tpu.terrain.synthetic import make_synthetic_grid \
        as jax_hill_grid
    from uneven_planner_tpu_torch.config import MapConfig
    from uneven_planner_tpu_torch.sim import ackermann as ak
    from uneven_planner_tpu_torch.sim import teleop
    from uneven_planner_tpu_torch.terrain.grid import se3_lift
    from uneven_planner_tpu_torch.terrain.synthetic import \
        make_synthetic_grid

    s = teleop.TeleopState()
    assert teleop.command(s) is None           # nothing held -> no publish
    s = teleop.key_down(s, "w")
    assert teleop.command(s) == (1.0, 0.0)     # bang-bang forward
    s = teleop.key_down(s, "a")
    assert teleop.command(s) == (1.0, 0.5)
    s = teleop.key_down(s, "s")                # opposite cancels forward
    assert s.down and not s.up
    assert teleop.command(s) == (-1.0, 0.5)
    s = teleop.key_down(s, "d")
    assert s.right and not s.left
    assert teleop.command(s) == (-1.0, -0.5)
    s = teleop.key_up(s, "s")
    s = teleop.key_up(s, "d")
    assert teleop.command(s) is None

    kw = dict(xy_resolution=0.25, yaw_resolution=0.6)
    grid = make_synthetic_grid(MapConfig(**kw), device="cpu")
    pose = torch.tensor([[0.7, -0.4, 0.9], [-2.0, 1.5, -2.5]],
                        dtype=torch.float64)
    p, q = ak.world_tf(grid, pose)
    R, p_ref = se3_lift(grid, pose)
    np.testing.assert_allclose(p.numpy(), p_ref.numpy(), atol=1e-6)
    for i in range(len(pose)):
        x, y, z, w = q[i].tolist()
        Rq = np.array([
            [1 - 2*(y*y + z*z), 2*(x*y - z*w), 2*(x*z + y*w)],
            [2*(x*y + z*w), 1 - 2*(x*x + z*z), 2*(y*z - x*w)],
            [2*(x*z - y*w), 2*(y*z + x*w), 1 - 2*(x*x + y*y)],
        ])
        np.testing.assert_allclose(Rq, R[i].numpy(), atol=1e-5)
    jg = jax_hill_grid(JMapConfig(**kw))
    jp, jq = jax.jit(jax.vmap(lambda a: jak.world_tf(jg, a)))(
        jnp.asarray(pose.numpy()))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-12)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-12)
