"""Port parity: the ALM inner cost, scaling, two-loop recursion and the flat
solver against the JAX package (f64, coarse hill grid, f16 packed table
attached as on the headline path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.config import ALMConfig
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu.solver import lbfgs as jlbfgs
from uneven_planner_tpu_torch import convert
from uneven_planner_tpu_torch.solver import alm as talm
from uneven_planner_tpu_torch.solver import lbfgs as tlbfgs

from torch_parity import (CPU, assert_lanes_match, jax_grid, lane_stability,
                          port_grid, scenarios, to_jax)

CFG = ALMConfig()
JSHAPE = jalm.ProblemShape(6, 12, 8)
TSHAPE = talm.ProblemShape(6, 12, 8)


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


def _rel(want, got):
    want = np.asarray(want)
    return np.abs(want - got.detach().numpy()).max() \
        / max(1.0, np.abs(want).max())


def _duals(n, seed):
    rng = np.random.default_rng(seed)
    E, I = JSHAPE.equal_num, JSHAPE.non_equal_num
    return (rng.normal(size=(n, E)) * 0.1,
            np.abs(rng.normal(size=(n, I))) * 0.1, np.full(n, 2.0))


def test_init_scaling_matches_jax(setup, monkeypatch):
    jg, tg, x0, bnd = setup
    monkeypatch.setattr(talm, "JAC_LANES", 3)  # several forward-mode passes
    want = jax.jit(jax.vmap(lambda x, b: jalm.init_scaling(
        x, b, JSHAPE, jg, CFG)))(jnp.asarray(x0), to_jax(bnd))
    got = talm.init_scaling(torch.tensor(x0),
                            convert.boundary_from_numpy(bnd, device=CPU),
                            TSHAPE, tg, CFG)
    assert _rel(want.scale_fx, got.scale_fx) < 1e-10
    assert _rel(want.scale_cx, got.scale_cx) < 1e-10


@pytest.mark.parametrize("exact", [True, False])
def test_inner_cost_aux_and_grad_match_jax(setup, exact):
    jg, tg, x0, bnd = setup
    lam, mu, rho = _duals(len(x0), 1)
    rng = np.random.default_rng(2)
    sfx = rng.uniform(0.1, 1.0, len(x0))
    scx = rng.uniform(0.1, 1.0, (len(x0), 7, JSHAPE.equal_num))

    def one(x, b, l, m, r, f, c):
        return jax.value_and_grad(jalm.inner_cost_aux, has_aux=True)(
            x, b, JSHAPE, jg, CFG, jalm.DualState(l, m, r),
            jalm.Scaling(f, c), exact)
    (jf, (jh, jgc)), jgrad = jax.jit(jax.vmap(one))(
        jnp.asarray(x0), to_jax(bnd), lam, mu, rho, sfx, scx)

    x = torch.tensor(x0, requires_grad=True)
    f, (h, g) = talm.inner_cost_aux(
        x, convert.boundary_from_numpy(bnd, device=CPU), TSHAPE, tg, CFG,
        convert.duals_from_numpy(lam, mu, rho, device=CPU),
        convert.scaling_from_numpy(sfx, scx, device=CPU), exact)
    grad, = torch.autograd.grad(f.sum(), x)
    for want, got in ((jf, f), (jh, h), (jgc, g), (jgrad, grad)):
        assert _rel(want, got) < 1e-10


def test_exact_residuals_match_jax(setup):
    jg, tg, x0, bnd = setup
    lam, mu, rho = _duals(len(x0), 3)
    sfx = np.ones(len(x0))
    scx = np.random.default_rng(4).uniform(0.1, 1.0,
                                           (len(x0), 7, JSHAPE.equal_num))
    wh, wg = jax.jit(jax.vmap(lambda x, b, l, m, r, f, c: jalm.exact_residuals(
        x, jalm.DualState(l, m, r), b, JSHAPE, jg, CFG, jalm.Scaling(f, c))))(
        jnp.asarray(x0), to_jax(bnd), lam, mu, rho, sfx, scx)
    gh, gg = talm.exact_residuals(
        torch.tensor(x0), convert.duals_from_numpy(lam, mu, rho, device=CPU),
        convert.boundary_from_numpy(bnd, device=CPU), TSHAPE, tg, CFG,
        convert.scaling_from_numpy(sfx, scx, device=CPU))
    assert _rel(wh, gh) < 1e-10 and _rel(wg, gg) < 1e-10


@pytest.mark.parametrize("bound", [0, 3, 8])
def test_two_loop_matches_jax(bound):
    rng = np.random.default_rng(bound)
    B, m, n = 6, 8, 17
    g = rng.normal(size=(B, n))
    S = rng.normal(size=(B, m, n))
    Y = S + 0.1 * rng.normal(size=(B, m, n))
    YS = np.einsum("bmn,bmn->bm", S, Y)
    end = rng.integers(0, m, B)
    bnd = np.full(B, bound)
    ys, yy = rng.uniform(0.5, 2.0, B), rng.uniform(0.5, 2.0, B)
    want = jax.vmap(lambda *a: jlbfgs._two_loop(*a, m))(
        *map(jnp.asarray, (g, S, Y, YS, end, bnd, ys, yy)))
    got = tlbfgs._two_loop(*map(torch.tensor, (g, S, Y, YS, end, bnd, ys,
                                               yy)), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_solve_flat_matches_jax_lane_by_lane(setup):
    """8 lanes on the f16 packed path, lane by lane against JAX's
    vmap(solve_flat)."""
    jg, tg, x0, bnd = setup
    ovr = {"mem_size": 8, "max_iterations": 40}
    run = jax.jit(jax.vmap(lambda x, b: jalm.solve_flat(
        x, b, JSHAPE, jg, CFG, lbfgs_overrides=ovr)))
    ref, stable, spread = lane_stability(run, x0, to_jax(bnd))
    res = talm.solve_flat(torch.tensor(x0),
                          convert.boundary_from_numpy(bnd, device=CPU),
                          TSHAPE, tg, CFG, lbfgs_overrides=ovr)
    assert_lanes_match(ref, res, stable, spread, min_stable=6)
    assert res.converged.all()
    assert res.steps >= int(res.evals.max())
    # the trajectory output is the decision vector's MINCO curve
    np.testing.assert_allclose(res.traj.c_xy.numpy(),
                               np.asarray(ref.traj.c_xy),
                               rtol=0, atol=1e-6 + 100 * spread.max())


def test_solve_flat_split_packed_matches_exact_population():
    """tests/test_alm.py:354 on the port: on the split hi+lo bf16 table
    (through `get_terrain_variables_cm(exact=False)`) the flat solver's
    convergence and solutions over a 64-scenario float32 population stay
    those of the exact pair-table path, within the gate's bounds, and the
    lanes it calls converged pass an exact-table recheck."""
    from uneven_planner_tpu_torch import manager
    from uneven_planner_tpu_torch.config import ManagerConfig, MapConfig
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import \
        make_synthetic_grid
    g32 = make_synthetic_grid(MapConfig(xy_resolution=0.2,
                                        yaw_resolution=0.45),
                              dtype=np.float32, device="cpu")
    gp = tgrid.with_pair_table(g32)
    gs = tgrid.with_packed_table(gp)
    shape = talm.ProblemShape(piece_xy=5, piece_yaw=10, int_K=8)
    rng = np.random.default_rng(23)
    N = 64
    x0s, bounds = [], []
    for _ in range(N):
        ang = rng.uniform(-np.pi, np.pi)
        start = rng.uniform(-3.5, -1.5, size=2)
        goal = np.clip(start + rng.uniform(1.2, 2.2)
                       * np.array([np.cos(ang), np.sin(ang)]), -4, 4)
        yaw = np.arctan2(goal[1] - start[1], goal[0] - start[0])
        t = np.linspace(0, 1, 16)[:, None]
        path = np.concatenate([(1 - t) * start + t * goal,
                               np.full((16, 1), yaw)], axis=1)
        x0, bound = manager.init_guess_fixed(path, ManagerConfig(),
                                             piece_xy=5, piece_yaw=10)
        x0s.append(x0)
        bounds.append(bound)
    f32 = lambda a: torch.tensor(np.stack(a), dtype=torch.float32)
    xs = f32(x0s)
    bs = talm.Boundary(*[f32([getattr(b, f) for b in bounds])
                         for f in talm.Boundary._fields])
    ov = {"mem_size": 16, "max_iterations": 100}
    r_exact = talm.solve_flat(xs, bs, shape, gp, CFG, lbfgs_overrides=ov)
    r_split = talm.solve_flat(xs, bs, shape, gs, CFG, lbfgs_overrides=ov)
    ce, cs = r_exact.converged.numpy(), r_split.converged.numpy()
    # the packed path must not lose convergences
    assert cs.mean() >= ce.mean() - 2.0 / N, (ce.sum(), cs.sum())
    both = ce & cs
    assert both.mean() > 0.9, (ce.sum(), cs.sum())
    # the same optimum on agreeing lanes, within the ALM tolerance band
    dx = np.abs(r_split.x.numpy()[both] - r_exact.x.numpy()[both])
    assert np.percentile(dx.max(axis=1), 90) < 5e-3, \
        np.percentile(dx.max(axis=1), 90)
    assert dx.max() < 2e-2, dx.max()
    # comparable effort
    ie = r_exact.inner_iters.numpy()[both].mean()
    is_ = r_split.inner_iters.numpy()[both].mean()
    assert is_ < 1.5 * ie, (ie, is_)
    # the reported residuals hold on the exact table
    scal = talm._make_scaling(xs, bs, shape, gp, CFG)
    zero = talm.DualState(lam=torch.zeros((N, shape.equal_num)),
                          mu=torch.zeros((N, shape.non_equal_num)),
                          rho=torch.full((N,), CFG.rho))
    rh, rg = talm.exact_residuals(r_split.x, zero, bs, shape, gp, CFG, scal)
    res_exact = torch.clamp(torch.maximum(rh, rg), min=0.0).numpy()
    viol = res_exact[cs] > CFG.epsilon_con * 1.05
    assert viol.mean() < 0.05, res_exact[cs].max()


def test_init_guess_fixed_takes_int_k_as_jax():
    """`manager.init_guess_fixed(..., int_K=...)`, a JAX call the port must
    take: accepted and unused, the guess equal to the JAX package's."""
    from uneven_planner_tpu import manager as jmanager
    from uneven_planner_tpu_torch import manager
    from uneven_planner_tpu_torch.config import ManagerConfig
    t = np.linspace(0, 1, 16)[:, None]
    path = np.concatenate([(1 - t) * np.array([-3.0, -3.0])
                           + t * np.array([-0.5, -1.0]),
                           np.full((16, 1), 0.7)], axis=1)
    want = jmanager.init_guess_fixed(path, ManagerConfig(), 6, 12, int_K=8)
    for k in (8, 16):
        x0, bound = manager.init_guess_fixed(path, ManagerConfig(), 6, 12,
                                             int_K=k)
        np.testing.assert_array_equal(x0, np.asarray(want[0]))
        for f in talm.Boundary._fields:
            np.testing.assert_array_equal(getattr(bound, f),
                                          np.asarray(getattr(want[1], f)))
