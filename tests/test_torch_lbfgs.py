"""Port parity: the batched L-BFGS with the Lewis-Overton line search
(`solver/lbfgs.py`) against the JAX package's `minimize`, the cases of
tests/test_lbfgs.py run on the port, each lane also held to `vmap` of the
JAX function (float64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.solver import lbfgs as jlbfgs
from uneven_planner_tpu_torch import convert
from uneven_planner_tpu_torch.solver import lbfgs as tlbfgs


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


def rosenbrock(x):
    return (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
            + (1 - x[..., :-1]) ** 2).sum(-1)


def quadratic(x):
    d = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype)
    return 0.5 * (d * x * x).sum(-1) - x.sum(-1)


def nonsmooth(x):
    return torch.abs(x - 0.3).sum(-1) + 0.5 * (x * x).sum(-1)


def jrosenbrock(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def jquadratic(x):
    d = jnp.arange(1, x.shape[0] + 1, dtype=x.dtype)
    return 0.5 * jnp.sum(d * x * x) - jnp.sum(x)


def jnonsmooth(x):
    return jnp.sum(jnp.abs(x - 0.3)) + 0.5 * jnp.sum(x * x)


def value_and_grad(fn):
    """Batched fn(x [B, n]) -> [B] as the port's objective: (f, grad)."""
    def fun(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            f = fn(xg)
            g, = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g
    return fun


def port_params(p: jlbfgs.LBFGSParams) -> tlbfgs.LBFGSParams:
    kw = dataclasses.asdict(p)
    kw.pop("two_loop_unroll")
    return tlbfgs.LBFGSParams(**kw)


PARAMS = jlbfgs.LBFGSParams(mem_size=16, g_epsilon=1e-8, past=3, delta=1e-12,
                            max_iterations=500)


def both(tfn, jfn, x0, params):
    """(port result, JAX `vmap(minimize)` result carried across by
    `convert.lbfgs_result_from_numpy`) from x0 [B, n]."""
    got = tlbfgs.minimize(value_and_grad(tfn), torch.tensor(x0),
                          port_params(params))
    want = jax.jit(jax.vmap(lambda x: jlbfgs.minimize(
        jax.value_and_grad(jfn), x, params)))(jnp.asarray(x0))
    return got, convert.lbfgs_result_from_numpy(
        jax.tree.map(np.asarray, want), device="cpu")


def assert_same_lanes(got, want, x_tol):
    """Equal status, iterations and evaluations per lane, x within x_tol
    (the two sum in other orders: ~1e-16 relative an operation)."""
    for name in ("status", "iters", "evals"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                               atol=x_tol)


def test_quadratic_exact():
    got, want = both(quadratic, jquadratic, np.zeros((1, 10)), PARAMS)
    np.testing.assert_allclose(got.x.numpy()[0], 1.0 / np.arange(1, 11),
                               atol=1e-6)
    assert int(got.status[0]) in (tlbfgs.CONVERGENCE, tlbfgs.STOP)
    assert_same_lanes(got, want, 1e-12)


def test_rosenbrock():
    got, want = both(rosenbrock, jrosenbrock, np.full((1, 6), -1.2), PARAMS)
    np.testing.assert_allclose(got.x.numpy()[0], np.ones(6), atol=1e-5)
    assert float(got.f[0]) < 1e-10
    assert_same_lanes(got, want, 1e-9)


def test_nonsmooth():
    params = jlbfgs.LBFGSParams(mem_size=16, g_epsilon=0.0, past=3,
                                delta=1e-14, max_iterations=500)
    got, want = both(nonsmooth, jnonsmooth, np.linspace(-2, 2, 8)[None],
                     params)
    # minimum of |x-0.3| + 0.5 x^2 is x=0.3 (subgradient contains 0)
    np.testing.assert_allclose(got.x.numpy()[0], 0.3, atol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), atol=1e-6)


def test_batch_converges_independently():
    x0 = np.random.default_rng(0).uniform(-2, 2, size=(8, 6))
    got, want = both(rosenbrock, jrosenbrock, x0, PARAMS)
    np.testing.assert_allclose(got.x.numpy(), np.ones((8, 6)), atol=1e-4)
    # different starts take different iteration counts
    assert len(set(got.iters.tolist())) > 1
    assert_same_lanes(got, want, 1e-9)
    # lockstep: the batch ran as many evaluations as its longest lane
    # (the first evaluation included)
    assert got.steps >= int(got.evals.max())


def test_max_iterations_status():
    params = jlbfgs.LBFGSParams(mem_size=8, g_epsilon=1e-12, past=0,
                                max_iterations=3)
    got, want = both(rosenbrock, jrosenbrock, np.full((1, 6), -1.2), params)
    assert int(got.status[0]) == tlbfgs.MAXITER
    assert int(got.iters[0]) == 3
    assert_same_lanes(got, want, 1e-12)


def test_two_loop_matches_both_jax_modes():
    """The port's `_two_loop` (batched, unrolled over the memory) against
    the JAX package's fori_loop and unrolled forms, at the float32 tolerance
    of tests/test_lbfgs.py."""
    rng = np.random.default_rng(0)
    m, n = 16, 66
    g = rng.normal(size=n).astype(np.float32)
    S = rng.normal(size=(m, n)).astype(np.float32)
    Y = (S + 0.1 * rng.normal(size=(m, n))).astype(np.float32)
    YS = np.einsum("ij,ij->i", S, Y)
    cases = ((3, 3), (0, 16), (7, 16), (5, 0), (15, 7))
    ends = np.array([c[0] for c in cases])
    bounds = np.array([c[1] for c in cases])
    ys = YS[ends - 1]
    yy = np.sum(Y[ends - 1] ** 2, axis=1)
    t = lambda a: torch.tensor(np.asarray(a))
    rep = lambda a: np.broadcast_to(a, (len(cases),) + a.shape)
    got = tlbfgs._two_loop(t(rep(g)), t(rep(S)), t(rep(Y)), t(rep(YS)),
                           t(ends), t(bounds), t(ys), t(yy), m).numpy()
    for unroll in (False, True):
        f = jax.jit(lambda *a: jlbfgs._two_loop(*a, m, unroll=unroll))
        for i, (end, bound) in enumerate(cases):
            want = f(jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y),
                     jnp.asarray(YS), jnp.asarray(end), jnp.asarray(bound),
                     jnp.asarray(ys[i]), jnp.asarray(yy[i]))
            np.testing.assert_allclose(got[i], np.asarray(want), rtol=2e-5,
                                       atol=2e-6)


def test_line_search_statuses_match_jax():
    """One batched search, a lane for each way it ends: accepted after
    bracketing, a non-descent direction (ERR_INCREASEGRADIENT before any
    evaluation), a NaN value (ERR_INVALIDFUNCVAL), the evaluation cap
    (ERR_MAXLINESEARCH), and a lane that does not search (`active`)."""
    params = jlbfgs.LBFGSParams(max_linesearch=3)
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, size=(5, 6))
    x[2, 0] = np.nan                      # every trial point is NaN
    fun = value_and_grad(rosenbrock)
    f, g = fun(torch.tensor(x))
    d = -g.numpy()
    d[1] = g.numpy()[1]                   # uphill
    stp0 = np.full(5, 1e-3)
    stp0[3] = 1e6                         # bisects from far past the valley
    got = tlbfgs._line_search(fun, torch.tensor(x), f, g, torch.tensor(d),
                              torch.tensor(stp0), port_params(params),
                              torch.tensor([True] * 4 + [False]))[0]
    jfun = jax.value_and_grad(jrosenbrock)
    want = jax.jit(jax.vmap(lambda a, b, c, e, s: jlbfgs._line_search(
        jfun, a, b, c, e, s, params)))(jnp.asarray(x), jnp.asarray(f.numpy()),
                                       jnp.asarray(g.numpy()), jnp.asarray(d),
                                       jnp.asarray(stp0))
    st = got.status.numpy()
    np.testing.assert_array_equal(
        st, [1, tlbfgs.ERR_INCREASEGRADIENT, tlbfgs.ERR_INVALIDFUNCVAL,
             tlbfgs.ERR_MAXLINESEARCH, 1])
    assert got.count.tolist() == [int(c) for c in np.asarray(want.count)[:4]] \
        + [0]
    np.testing.assert_array_equal(st[:4], np.asarray(want.status)[:4])
    ok = [0, 1, 3]
    np.testing.assert_allclose(got.stp.numpy()[ok],
                               np.asarray(want.stp)[ok], rtol=1e-15)
    np.testing.assert_allclose(got.x.numpy()[ok], np.asarray(want.x)[ok],
                               rtol=1e-13)
    # the lane that does not search keeps its start
    np.testing.assert_array_equal(got.x.numpy()[4], x[4])
