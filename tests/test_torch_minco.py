"""Port parity: uniform-MINCO constant operators (bit-identical), the
batched MINCO functions plus the tau <-> T maps (f64, within 1e-12), and the
general MINCO solve (block-tridiagonal Thomas recursion, `generate`,
`jerk_cost` and its gradient through autograd; f64, within 1e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.minco import banded as jbanded
from uneven_planner_tpu.minco import minco as jminco
from uneven_planner_tpu.minco import uniform as ju
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu_torch.minco import banded, minco
from uneven_planner_tpu_torch.minco import uniform as tu
from uneven_planner_tpu_torch.solver import alm as talm

SHAPES = [(6, 12, 8), (10, 20, 8), (5, 10, 16)]


@pytest.mark.parametrize("N,Nyaw,K", SHAPES)
def test_constant_operators_bit_identical(N, Nyaw, K):
    np.testing.assert_array_equal(tu._solve_matrix(N), ju._solve_matrix(N))
    np.testing.assert_array_equal(tu._jerk_q_block(N), ju._jerk_q_block(N))
    for a, b in zip(tu.sample_matrices(N, Nyaw, K),
                    ju.sample_matrices(N, Nyaw, K)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tu.sample_plan(N, Nyaw, K), ju.sample_plan(N, Nyaw, K)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tu.trapz_weights(N, K),
                                  jalm._trapz_weights(N, K))
    ops = tu.uniform_ops(N, Nyaw, K, torch.float64, torch.device("cpu"))
    np.testing.assert_array_equal(ops.gt_xy.numpy(), ju._solve_matrix(N).T)
    np.testing.assert_array_equal(ops.sxy_t.numpy(),
                                  ju.sample_matrices(N, Nyaw, K)[0].T)
    np.testing.assert_array_equal(ops.q_yaw.numpy(), ju._jerk_q_block(Nyaw))


@pytest.mark.parametrize("N,dim", [(6, 2), (12, 1), (20, 1)])
def test_generate_norm_and_jerk_match_jax(N, dim):
    rng = np.random.default_rng(N)
    B = 5
    inner = rng.normal(size=(B, N - 1, dim))
    head = rng.normal(size=(B, 3, dim))
    tail = rng.normal(size=(B, 3, dim))
    Tp = rng.uniform(0.2, 2.0, B)
    want = np.stack([np.asarray(ju.generate_norm_cm(
        jnp.asarray(inner[b]), jnp.asarray(Tp[b]), jnp.asarray(head[b]),
        jnp.asarray(tail[b]), N)) for b in range(B)])
    ops = tu.uniform_ops(N, N, 8, torch.float64, torch.device("cpu"))
    t = torch.tensor
    got = tu.generate_norm_cm(t(inner), t(Tp), t(head), t(tail), ops.gt_xy)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)

    jerk = np.array([float(ju.jerk_cost_norm_cm(jnp.asarray(want[b]),
                                                jnp.asarray(Tp[b]), N))
                     for b in range(B)])
    got_j = tu.jerk_cost_norm_cm(t(want), t(Tp), ops.q_xy).numpy()
    np.testing.assert_allclose(got_j, jerk, rtol=1e-12)

    # layout and denormalization of the physical coefficients
    cn = np.stack([np.asarray(ju.generate_norm(
        jnp.asarray(inner[b]), jnp.asarray(Tp[b]), jnp.asarray(head[b]),
        jnp.asarray(tail[b]), N)) for b in range(B)])
    phys = np.stack([np.asarray(ju.denormalize(jnp.asarray(cn[b]),
                                               jnp.asarray(Tp[b])))
                     for b in range(B)])
    got_p = tu.denormalize(tu.coeffs_from_cm(got, N), t(Tp)).numpy()
    np.testing.assert_allclose(got_p, phys, rtol=1e-12, atol=1e-12)


def test_expc2_logc2_pack_unpack_match_jax():
    taus = np.array([-3.0, -0.5, -1e-9, 0.0, 1e-9, 0.7, 2.5])
    Ts = np.array([0.05, 0.5, 1.0, 1.0 + 1e-9, 3.0, 40.0])
    np.testing.assert_allclose(talm.expC2(torch.tensor(taus)).numpy(),
                               np.asarray(jalm.expC2(jnp.asarray(taus))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(talm.logC2(torch.tensor(Ts)).numpy(),
                               np.asarray(jalm.logC2(jnp.asarray(Ts))),
                               rtol=1e-12, atol=1e-12)
    shape = talm.ProblemShape(6, 12, 8)
    x = np.random.default_rng(0).normal(size=(3, shape.num_vars))
    tau, pxy, pyaw = talm.unpack(torch.tensor(x), shape)
    jshape = jalm.ProblemShape(6, 12, 8)
    jt, jxy, jyaw = jax.vmap(lambda a: jalm.unpack(a, jshape))(
        jnp.asarray(x))
    np.testing.assert_array_equal(pxy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(pyaw.numpy(), np.asarray(jyaw))
    np.testing.assert_array_equal(talm.pack(tau, pxy, pyaw).numpy(), x)


# ---------------------------------------------------------------------------
# general MINCO: banded solve, generate, jerk cost and its gradient
# ---------------------------------------------------------------------------

def _random_blocks(rng, B, N, k, m):
    L = rng.normal(size=(B, N, k, k)) * 0.1
    U = rng.normal(size=(B, N, k, k)) * 0.1
    D = rng.normal(size=(B, N, k, k)) * 0.1 + np.eye(k) * 3.0
    return L, D, U, rng.normal(size=(B, N, k, m))


@pytest.mark.parametrize("N,k,m", [(7, 6, 2), (2, 6, 1), (5, 3, 4)])
def test_block_tridiag_solve_matches_jax_and_dense(N, k, m):
    rng = np.random.default_rng(N)
    B = 3
    L, D, U, b = _random_blocks(rng, B, N, k, m)
    got = banded.block_tridiag_solve(*map(torch.tensor, (L, D, U, b)))
    for i in range(B):
        want = jbanded.block_tridiag_solve(*(jnp.asarray(a[i])
                                             for a in (L, D, U, b)))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-9)
        A = np.zeros((N * k, N * k))
        for j in range(N):
            A[j*k:(j+1)*k, j*k:(j+1)*k] = D[i, j]
            if j > 0:
                A[j*k:(j+1)*k, (j-1)*k:j*k] = L[i, j]
            if j < N - 1:
                A[j*k:(j+1)*k, (j+1)*k:(j+2)*k] = U[i, j]
        np.testing.assert_allclose(got[i].numpy().reshape(-1, m),
                                   np.linalg.solve(A, b[i].reshape(-1, m)),
                                   rtol=1e-9, atol=1e-10)
    # matvec consistency, and one system without the lane dimension
    Ax = banded.block_tridiag_matvec(*map(torch.tensor, (L, D, U)), got)
    np.testing.assert_allclose(Ax.numpy(), b, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(
        banded.block_tridiag_matvec(*(torch.tensor(a[0]) for a in (L, D, U)),
                                    got[0]).numpy(),
        np.asarray(jbanded.block_tridiag_matvec(
            *(jnp.asarray(a[0]) for a in (L, D, U)),
            jnp.asarray(got[0].numpy()))), atol=1e-12)
    one = banded.block_tridiag_solve(*(torch.tensor(a[0])
                                       for a in (L, D, U, b)))
    np.testing.assert_allclose(one.numpy(), got[0].numpy(), atol=1e-12)


def test_gauss_solve_matches_jax():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(4, 6, 6)) * 0.2 + np.eye(6) * 2.0
    Bm = rng.normal(size=(4, 6, 3))
    got = banded.gauss_solve(torch.tensor(M), torch.tensor(Bm))
    for i in range(4):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(jbanded.gauss_solve(
                jnp.asarray(M[i]), jnp.asarray(Bm[i]))), rtol=1e-12,
            atol=1e-12)
    np.testing.assert_allclose(M @ got.numpy(), Bm, atol=1e-10)


def _minco_problem(B, N, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N - 1, dim)),
            rng.uniform(0.5, 1.5, size=(B, N)),
            rng.normal(size=(B, 3, dim)), rng.normal(size=(B, 3, dim)))


@pytest.mark.parametrize("N,dim", [(8, 2), (2, 1), (16, 1)])
def test_generate_and_eval_piece_match_jax(N, dim):
    B = 3
    inner, ts, head, tail = _minco_problem(B, N, dim, seed=N)
    c = minco.generate(*map(torch.tensor, (inner, ts, head, tail)))
    assert c.shape == (B, N, 6, dim)
    for b in range(B):
        want = jminco.generate(*(jnp.asarray(a[b])
                                 for a in (inner, ts, head, tail)))
        np.testing.assert_allclose(c[b].numpy(), np.asarray(want),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(
            float(minco.jerk_cost(c, torch.tensor(ts))[b]),
            float(jminco.jerk_cost(want, jnp.asarray(ts[b]))), rtol=1e-9)
        for i in (0, N - 1):
            s = 0.37 * ts[b, i]
            got = minco.eval_piece(c[b, i], torch.tensor(s))
            for g, w in zip(got, jminco.eval_piece(want[i], jnp.asarray(s))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-9, atol=1e-9)
    # the defining conditions: boundary PVA and the inner waypoints
    p0, v0, a0, _ = minco.eval_piece(c[:, 0], torch.zeros(B).double())
    np.testing.assert_allclose(torch.stack([p0, v0, a0], 1).numpy(), head,
                               atol=1e-9)
    ends = minco.eval_piece(c[:, :-1], torch.tensor(ts[:, :-1]))[0]
    np.testing.assert_allclose(ends.numpy(), inner, atol=1e-8)
    with pytest.raises(ValueError):
        minco.generate(torch.zeros(1, 0, 2), torch.ones(1, 1),
                       torch.zeros(1, 3, 2), torch.zeros(1, 3, 2))


def test_jerk_cost_gradient_through_generate_matches_jax_grad():
    """Autograd through the Thomas recursion against `jax.grad` of the same
    chain, with respect to inner points and piece times (1e-9 relative to
    the gradient's size)."""
    B, N = 3, 8
    inner, ts, head, tail = _minco_problem(B, N, 2, seed=1)
    ti = torch.tensor(inner, requires_grad=True)
    tt = torch.tensor(ts, requires_grad=True)
    cost = minco.jerk_cost(minco.generate(ti, tt, torch.tensor(head),
                                          torch.tensor(tail)), tt)
    cost.sum().backward()
    for b in range(B):
        gi, gt = jax.grad(lambda i, s: jminco.jerk_cost(jminco.generate(
            i, s, jnp.asarray(head[b]), jnp.asarray(tail[b])), s),
            argnums=(0, 1))(jnp.asarray(inner[b]), jnp.asarray(ts[b]))
        for got, want in ((ti.grad[b], gi), (tt.grad[b], gt)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                       atol=1e-9 * np.abs(want).max())


def test_generate_se2_and_jerk_cost_se2_match_jax():
    ixy, txy, hxy, lxy = _minco_problem(2, 5, 2, seed=3)
    iyaw, tyaw, hyaw, lyaw = _minco_problem(2, 10, 1, seed=4)
    args = (ixy, txy, hxy, lxy, iyaw, tyaw, hyaw, lyaw)
    c_xy, c_yaw = minco.generate_se2(*map(torch.tensor, args))
    cost = minco.jerk_cost_se2(c_xy, torch.tensor(txy), c_yaw,
                               torch.tensor(tyaw))
    for b in range(2):
        wxy, wyaw = jminco.generate_se2(*(jnp.asarray(a[b]) for a in args))
        np.testing.assert_allclose(c_xy[b].numpy(), np.asarray(wxy),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(c_yaw[b].numpy(), np.asarray(wyaw),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(cost[b]), float(jminco.jerk_cost_se2(
            wxy, jnp.asarray(txy[b]), wyaw, jnp.asarray(tyaw[b]))),
            rtol=1e-9)


# ---------------------------------------------------------------------------
# row-major uniform MINCO (uniform.py:126-175) and the root finder
# ---------------------------------------------------------------------------

def test_uniform_fast_path_matches_generate():
    """tests/test_minco.py:150 on the port: the constant-inverse path equals
    the general `generate` for uniform piece times (coefficients and jerk
    energy, 1e-9), and equals the JAX package's `generate_norm` and
    `jerk_cost_norm` (1e-12)."""
    rng = np.random.default_rng(7)
    t = torch.tensor
    for N, dim in [(2, 2), (5, 2), (10, 2), (20, 1)]:
        B = 3
        Tp = np.array([0.37, 0.8, 1.9])
        inner = rng.normal(size=(B, N - 1, dim))
        head = rng.normal(size=(B, 3, dim))
        tail = rng.normal(size=(B, 3, dim))
        ts = t(np.repeat(Tp[:, None], N, 1))
        c_ref = minco.generate(t(inner), ts, t(head), t(tail))
        cn = tu.generate_norm(t(inner), t(Tp), t(head), t(tail), N)
        np.testing.assert_allclose(tu.denormalize(cn, t(Tp)).numpy(),
                                   c_ref.numpy(), rtol=1e-9, atol=1e-9)
        jerk = tu.jerk_cost_norm(cn, t(Tp), N)
        np.testing.assert_allclose(jerk.numpy(),
                                   minco.jerk_cost(c_ref, ts).numpy(),
                                   rtol=1e-9)
        for b in range(B):
            want = ju.generate_norm(*map(jnp.asarray, (inner[b], Tp[b],
                                                       head[b], tail[b])), N)
            np.testing.assert_allclose(cn[b].numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(
                float(jerk[b]),
                float(ju.jerk_cost_norm(want, jnp.asarray(Tp[b]), N)),
                rtol=1e-12)


def test_uniform_sample_plan_static_yaw_location():
    """tests/test_minco.py:172 on the port: the static yaw-piece mapping of
    the sample plan agrees with locating by global time
    (alm_traj_opt.cpp:747-764) through `eval_traj`."""
    N, Nyaw, K = 10, 20, 16
    _, _, _, yidx, BY0, BY1 = tu.sample_plan(N, Nyaw, K)
    rng = np.random.default_rng(3)
    Tp = 0.21
    Tpy = Tp * N / Nyaw
    t = torch.tensor
    inner = rng.normal(size=(1, Nyaw - 1, 1))
    head = rng.normal(size=(1, 3, 1))
    tail = rng.normal(size=(1, 3, 1))
    ts = t(np.full((1, Nyaw), Tpy))
    c = minco.generate(t(inner), ts, t(head), t(tail))
    cn = tu.generate_norm(t(inner), t([Tpy]), t(head), t(tail), Nyaw)[0]
    cy = cn[yidx.reshape(-1), :, 0].numpy()
    yaw_static = np.sum(BY0.reshape(-1, 6) * cy, axis=-1)
    dyaw_static = np.sum(BY1.reshape(-1, 6) * cy, axis=-1) / Tpy
    u = np.arange(K + 1) / K
    t_glob = ((np.arange(N)[:, None] + u[None, :]) * Tp).reshape(-1)
    val, dot, _, _ = minco.eval_traj(c, ts, t(t_glob[None]))
    np.testing.assert_allclose(yaw_static, val[0, :, 0].numpy(), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(dyaw_static, dot[0, :, 0].numpy(), rtol=1e-7,
                               atol=1e-9)


def test_roots_match_numpy_and_jax():
    """tests/test_rootfinder.py on the port: Durand-Kerner roots of five
    quintics at once against numpy's (1e-5) and the JAX package's
    (1e-12)."""
    from uneven_planner_tpu.utils import rootfinder as jrf
    from uneven_planner_tpu_torch.utils import rootfinder as rf
    rng = np.random.default_rng(0)
    P = rng.normal(size=(5, 6))
    z = rf.roots(torch.tensor(P)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jrf.roots))(jnp.asarray(P)))
    for p, zp, zj in zip(P, z, want):
        z_np = np.roots(p)
        key = lambda a: a[np.argsort(a.real + 1e-6 * a.imag)]
        np.testing.assert_allclose(key(zp), key(z_np), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(zp, zj, rtol=0, atol=1e-12)


def test_poly_val_and_sqr():
    from uneven_planner_tpu_torch.utils import rootfinder as rf
    p = torch.tensor([2.0, -1.0, 3.0], dtype=torch.float64)  # 2x^2 - x + 3
    assert float(rf.poly_val(p, torch.tensor(2.0, dtype=p.dtype))) == 9.0
    sq = rf.poly_sqr(p).numpy()
    np.testing.assert_allclose(np.polyval(sq, 1.7),
                               np.polyval(p.numpy(), 1.7) ** 2, rtol=1e-12)
    np.testing.assert_array_equal(rf.poly_der(p).numpy(), [4.0, -1.0])


def test_max_vel_rate_exact_vs_dense():
    """Root-isolation max ||v|| matches (and upper-bounds) dense sampling,
    and equals the JAX package's (1e-9)."""
    from uneven_planner_tpu.utils import rootfinder as jrf
    from uneven_planner_tpu_torch.minco.traj import SE2Traj, max_vel_rate
    from uneven_planner_tpu_torch.utils import rootfinder as rf
    rng = np.random.default_rng(1)
    N = 5
    t = torch.tensor
    inner = rng.normal(size=(1, N - 1, 2))
    ts = rng.uniform(0.6, 1.4, size=(1, N))
    head = np.array([[[0.0, 0.0], [0.4, 0.1], [0.0, 0.0]]])
    tail = np.array([[[1.5, 1.0], [0.0, -0.2], [0.0, 0.0]]])
    c_xy = minco.generate(t(inner), t(ts), t(head), t(tail))
    exact = float(rf.max_vel_rate_exact(c_xy, t(ts))[0])
    c_yaw = minco.generate(torch.zeros((1, N - 1, 1), dtype=torch.float64),
                           t(ts), torch.zeros((1, 3, 1), dtype=torch.float64),
                           torch.zeros((1, 3, 1), dtype=torch.float64))
    dense = float(max_vel_rate(SE2Traj(c_xy, t(ts), c_yaw, t(ts)),
                               num_samples=4096)[0])
    assert exact >= dense - 1e-6, "root-based max below sampled max"
    np.testing.assert_allclose(exact, dense, rtol=2e-3)
    want = jax.jit(jrf.max_vel_rate_exact)(jnp.asarray(c_xy[0].numpy()),
                                           jnp.asarray(ts[0]))
    np.testing.assert_allclose(exact, float(want), rtol=1e-9)
