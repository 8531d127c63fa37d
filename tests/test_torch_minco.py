"""Port parity: uniform-MINCO constant operators (bit-identical) and the
batched MINCO functions plus the tau <-> T maps (f64, within 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.minco import uniform as ju
from uneven_planner_tpu.solver import alm as jalm
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
