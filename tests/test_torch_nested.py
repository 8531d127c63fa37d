"""Port parity: the reference's nested PHR-ALM solve (`alm.solve`,
`solve_compacted`, `outer_round`, `debug_iterates`, `inner_cost`) against
the JAX package (float64, coarse hill grid with the pair and f16 tables:
the nested solve reads the exact pair table), and the nested gates of
tests/test_alm.py run on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.config import ALMConfig
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu_torch import convert, manager
from uneven_planner_tpu_torch.config import ManagerConfig
from uneven_planner_tpu_torch.minco.traj import max_metrics, non_hol_error
from uneven_planner_tpu_torch.solver import alm as talm

from torch_parity import (CPU, assert_lanes_match, jax_grid, lane_stability,
                          port_grid, scenarios, to_jax)

CFG = ALMConfig()
JSHAPE = jalm.ProblemShape(6, 12, 8)
TSHAPE = talm.ProblemShape(6, 12, 8)
# the inner caps of tests/test_alm.py:201 (8 lanes) and :17 (single paths)
OVR = {"mem_size": 8, "max_iterations": 40}
LB_OVR = {"mem_size": 32, "max_iterations": 250}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """The CPU loops of these tests are thousands of small tensor
    operations, where PyTorch's thread pool only adds hand-off cost (and
    oversubscribes the cores under parallel test workers): run them on one
    thread and put the setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jg = jax_grid()
    x0, bnd = scenarios(8, 9, 6, 12)
    return jg, port_grid(jg), x0, bnd


@pytest.fixture(scope="module")
def nested(setup):
    """(JAX `vmap(solve)` with its lane stability, the port's `solve`) on
    the 8 lanes."""
    jg, tg, x0, bnd = setup
    run = jax.jit(jax.vmap(lambda x, b: jalm.solve(
        x, b, JSHAPE, jg, CFG, lbfgs_overrides=OVR)))
    ref, stable, spread = lane_stability(
        run, x0, to_jax(bnd), eps=(1e-15, -1e-15, 1e-14, -1e-14))
    res = talm.solve(torch.tensor(x0),
                     convert.boundary_from_numpy(bnd, device=CPU), TSHAPE,
                     tg, CFG, lbfgs_overrides=OVR)
    return ref, stable, spread, res


def test_solve_matches_jax_lane_by_lane(nested):
    """Equal outer rounds, inner iterations, L-BFGS status and converged
    flag on the lanes whose counts no 1e-15 input change moves, x within
    10x JAX's own spread there and within the ALM band (2e-2) elsewhere;
    `evals` is None in both (alm.py:497-500)."""
    ref, stable, spread, res = nested
    assert ref.evals is None and res.evals is None
    assert_lanes_match(ref, res, stable, spread, min_stable=6)
    assert res.converged.all()
    # lockstep: the batch ran at least as many evaluations as any lane's
    # inner iterations, and read a lane mask before each
    assert res.steps >= int(res.inner_iters.max())
    assert res.polls > res.steps
    # the trajectory is the decision vector's MINCO curve (row-major path)
    rel = np.abs(res.traj.c_xy.numpy() - np.asarray(ref.traj.c_xy)).max(
        (1, 2, 3)) / np.abs(np.asarray(ref.traj.c_xy)).max((1, 2, 3))
    assert (rel[stable] < 1e-9 + 100 * spread[stable]).all(), rel


def test_solve_compacted_equals_solve_per_lane(setup, nested):
    """tests/test_alm.py:201 on the port: the lane-retiring solve
    (buckets of 8, 4 and 2 lanes, padded by the first live lane) gives
    `solve`'s lanes (rtol 1e-10)."""
    _, tg, x0, bnd = setup
    res = nested[3]
    com = talm.solve_compacted(torch.tensor(x0),
                               convert.boundary_from_numpy(bnd, device=CPU),
                               TSHAPE, tg, CFG, lbfgs_overrides=OVR,
                               buckets=(1, 2, 4))
    np.testing.assert_allclose(com.x.numpy(), res.x.numpy(), rtol=1e-10,
                               atol=1e-12)
    for name in ("converged", "outer_iters", "inner_iters", "lbfgs_status"):
        np.testing.assert_array_equal(getattr(com, name).numpy(),
                                      getattr(res, name).numpy(), name)
    assert com.evals is None and com.steps > 0


def test_outer_round_from_a_jax_state_matches_jax(setup):
    """Both packages take one outer round from the same SolveState (the
    JAX package's `vmap(init_state)` carried across by
    `convert.solve_state_from_numpy`) and land on the same state."""
    jg, tg, x0, bnd = setup
    p = jalm.lbfgs_params_from(CFG)
    p = jalm.dataclasses.replace(p, **OVR)
    B = convert.boundary_from_numpy(bnd, device=CPU)
    # the scaling (held to JAX's in test_torch_alm.py) goes to both
    scal = talm.init_scaling(torch.tensor(x0), B, TSHAPE, tg, CFG)

    @jax.jit
    def one_round(x, b, fx, cx):
        s0 = jax.vmap(lambda xi: jalm.init_state(xi, JSHAPE, CFG))(x)
        s1 = jax.vmap(lambda s, bi, f, c: jalm.outer_round(
            s, bi, jalm.Scaling(f, c), JSHAPE, jg, CFG, p))(s0, b, fx, cx)
        return s0, s1
    s0, s1 = jax.tree.map(np.asarray, one_round(
        jnp.asarray(x0), to_jax(bnd), scal.scale_fx.numpy(),
        scal.scale_cx.numpy()))
    start = convert.solve_state_from_numpy(s0, device=CPU)
    got, res = talm.outer_round(start, B, scal, TSHAPE, tg, CFG,
                                talm._params(CFG, OVR))
    want = convert.solve_state_from_numpy(s1, device=CPU)
    for name in ("it", "done", "inner_iters", "lbfgs_status"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(res.iters, want.inner_iters)
    # 40 L-BFGS iterations summed in another order than XLA's
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                               atol=1e-8)
    for a, b in ((got.duals.lam, want.duals.lam), (got.duals.mu,
                                                   want.duals.mu),
                 (got.res_h, want.res_h), (got.res_g, want.res_g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_debug_iterates_rows_match_jax(setup):
    """4 lanes x 64 evaluations of the optimization stepper: the round,
    iteration and validity rows equal JAX's `vmap(debug_iterates)`, the
    iterates and values within 1e-8 (the flat step sums in another order
    than XLA)."""
    jg, tg, x0, bnd = setup
    n = 4
    b4 = jax.tree.map(lambda a: a[:n], bnd)
    want = jax.jit(jax.vmap(lambda x, b: jalm.debug_iterates(
        x, b, JSHAPE, jg, CFG, max_evals=64, lbfgs_overrides=OVR)))(
        jnp.asarray(x0[:n]), to_jax(b4))
    got = talm.debug_iterates(torch.tensor(x0[:n]),
                              convert.boundary_from_numpy(b4, device=CPU),
                              TSHAPE, tg, CFG, max_evals=64,
                              lbfgs_overrides=OVR)
    assert got["x"].shape == (n, 64, TSHAPE.num_vars)
    for k in ("outer", "inner", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["f"].numpy(), np.asarray(want["f"]),
                               rtol=1e-10)


def _straight_path(start, goal, n=40):
    t = np.linspace(0.0, 1.0, n)[:, None]
    xy = (1 - t) * np.asarray(start[:2]) + t * np.asarray(goal[:2])
    yaw = np.full((n, 1), np.arctan2(goal[1] - start[1], goal[0] - start[0]))
    return np.concatenate([xy, yaw], axis=1)


def _one_lane(path):
    x0, bound, shape = manager.init_guess_from_path(path, ManagerConfig())
    lane = talm.Boundary(*[torch.tensor(np.asarray(a)[None]) for a in bound])
    return torch.tensor(x0[None]), lane, shape


def test_inner_cost_and_gradient_match_jax_and_fd(setup):
    """tests/test_alm.py:130 on the port: `inner_cost` and its autograd
    gradient against the JAX package's (1e-10 relative; the gradient 1e-9
    of its largest component, ~1e5, as the two differentiate the lookup
    differently) and against central differences (rtol 5e-5)."""
    jg, tg, _, _ = setup
    x0, B, shape = _one_lane(_straight_path((-3.0, -3.0), (-1.0, -3.0)))
    E, I = shape.equal_num, shape.non_equal_num
    rng = np.random.default_rng(0)
    lam, mu = rng.normal(size=E) * 0.1, np.abs(rng.normal(size=I)) * 0.1
    duals = convert.duals_from_numpy(lam[None], mu[None], [2.0], device=CPU)
    scaling = talm.Scaling(
        scale_fx=torch.tensor([0.7], dtype=torch.float64),
        scale_cx=talm.default_scale_cx(shape, CFG, 1, torch.float64, CPU))
    cost = lambda x: talm.inner_cost(x, B, shape, tg, CFG, duals, scaling)
    xg = x0.clone().requires_grad_(True)
    f = cost(xg)
    g, = torch.autograd.grad(f.sum(), xg)
    f = f.detach()

    jshape = jalm.ProblemShape(shape.piece_xy, shape.piece_yaw, shape.int_K)
    jb = jax.tree.map(lambda a: jnp.asarray(a[0].numpy()), B)
    jd = jalm.DualState(jnp.asarray(lam), jnp.asarray(mu), jnp.asarray(2.0))
    js = jalm.Scaling(jnp.asarray(0.7), jalm.default_scale_cx(
        jshape, CFG, jnp.float64))
    jf, jgrad = jax.jit(jax.value_and_grad(lambda x: jalm.inner_cost(
        x, jb, jshape, jg, CFG, jd, js)))(jnp.asarray(x0[0].numpy()))
    np.testing.assert_allclose(float(f[0]), float(jf), rtol=1e-10)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(jgrad)).max())
    # eps=1e-5: the cost is ~1e5 while some gradient components are ~0.1
    eps = 1e-5
    n = x0.shape[1]
    for j in [0, 1, n // 2, n - 1]:
        e = torch.zeros_like(x0)
        e[0, j] = eps
        with torch.no_grad():
            fd = (float(cost(x0 + e)[0]) - float(cost(x0 - e)[0])) / (2 * eps)
        np.testing.assert_allclose(float(g[0, j]), fd, rtol=5e-5, atol=1e-6,
                                   err_msg=f"x[{j}]")


def test_solve_converges_within_the_report_bounds(setup):
    """tests/test_alm.py:40-80 on the port: the reference solve of a
    straight hill path converges below epsilon_con, the post-solve report
    stays within the configured bounds, the non-holonomic error is small and
    the boundary states are hit."""
    _, tg, _, _ = setup
    x0, B, shape = _one_lane(_straight_path((-3.0, -3.0), (0.0, -3.0)))
    res = talm.solve(x0, B, shape, tg, CFG, lbfgs_overrides=LB_OVR)
    assert bool(res.converged[0]), (res.res_h, res.res_g, res.outer_iters)
    assert float(res.res_h[0]) < CFG.epsilon_con
    assert float(res.res_g[0]) < CFG.epsilon_con
    m = {k: float(v[0]) for k, v in max_metrics(res.traj, tg, 2048).items()}
    tol = 1.05  # scaled-constraint tolerance translates to small overshoot
    assert m["max_vx"] <= CFG.max_vel * tol + 0.05
    assert m["max_ax"] <= CFG.max_acc_lon * tol
    assert m["max_ay"] <= CFG.max_acc_lat * tol
    assert m["max_cur"] <= CFG.max_kap * tol + 0.1
    assert m["min_cxi"] >= CFG.min_cxi / tol
    assert m["max_sig"] <= CFG.max_sig * tol + 1e-3
    assert float(non_hol_error(res.traj, 2048)[0]) < 0.5
    c_xy = res.traj.c_xy[0].numpy()
    T = float(res.traj.ts_xy[0, -1])
    np.testing.assert_allclose(c_xy[0, 0], [-3.0, -3.0], atol=1e-8)
    np.testing.assert_allclose(c_xy[-1].T @ T ** np.arange(6), [0.0, -3.0],
                               atol=1e-8)


def test_determinism_and_warm_duals(setup):
    """tests/test_alm.py:164-200 on the port: two solves agree bit for bit,
    and re-solving the solution with warmed duals (rho = 4) converges in no
    more outer rounds."""
    _, tg, _, _ = setup
    x0, B, shape = _one_lane(_straight_path((-3.0, -3.0), (-1.5, -3.0)))
    r1 = talm.solve(x0, B, shape, tg, CFG, lbfgs_overrides=LB_OVR)
    r2 = talm.solve(x0, B, shape, tg, CFG, lbfgs_overrides=LB_OVR)
    assert torch.equal(r1.x, r2.x)
    assert torch.equal(r1.inner_iters, r2.inner_iters)
    warm = talm.DualState(
        lam=torch.zeros(shape.equal_num, dtype=torch.float64),
        mu=torch.zeros(shape.non_equal_num, dtype=torch.float64),
        rho=torch.tensor(4.0, dtype=torch.float64))
    re = talm.solve(r1.x, B, shape, tg, CFG, lbfgs_overrides=LB_OVR,
                    warm_duals=warm)
    assert bool(re.converged[0])
    assert int(re.outer_iters[0]) <= int(r1.outer_iters[0])
