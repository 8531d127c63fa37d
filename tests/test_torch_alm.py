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
