"""f64 dense QP reference solver (the MPC golden-control-sequence oracle;
port of `uneven_planner_tpu/utils/qp_ref.py`, numpy only, same algorithm).

The reference controller solves its condensed tracking QP with OSQP
(reference: src/uneven_planner/mpc_controller/src/mpc.cpp:513-542, tol
1e-6).  BASELINE's acceptance gate is <1e-3 max control-sequence error vs
that solve.  OSQP itself is not available in this environment, so the
oracle here is stronger: a primal-dual active-set iteration in numpy
float64 whose output is CERTIFIED by explicit KKT residuals — for the
strictly convex MPC QP (P > 0), any point passing stationarity, primal
feasibility, and complementarity to ~1e-9 IS the unique optimum, which is
exactly the point OSQP approximates at its 1e-6 tolerance.

    min 1/2 z'Pz + q'z   s.t.   l <= Az <= u      (P symmetric PD)

Algorithm: semi-smooth Newton / primal-dual active-set (Hintermueller-Ito-
Kunisch style).  Each iteration solves the equality KKT system on the
current working set (rows pinned at their active bound), then updates the
working set from the signs of the duals and the bound violations.  A
post-loop certification rejects any non-converged run loudly.
"""

from __future__ import annotations

import numpy as np


class QPRefError(RuntimeError):
    """The reference solver failed to certify an optimum."""


def kkt_residuals_f64(P, q, A, l, u, z, y):
    """(stationarity, primal, complementarity) inf-norm residuals."""
    Az = A @ z
    stat = np.max(np.abs(P @ z + q + A.T @ y))
    prim = np.max(np.maximum(Az - u, 0.0) + np.maximum(l - Az, 0.0)) \
        if len(l) else 0.0
    comp = np.max(np.abs(np.where(y > 0, (Az - u) * y, (Az - l) * y))) \
        if len(l) else 0.0
    return stat, prim, comp


def solve_qp_f64(P, q, A, l, u, max_iter: int = 200, tol: float = 1e-9):
    """Certified f64 solve; returns (z, y).  Raises QPRefError if the
    active-set iteration cannot produce a KKT-certified optimum."""
    P = np.asarray(P, np.float64)
    q = np.asarray(q, np.float64)
    A = np.asarray(A, np.float64)
    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    n = q.shape[0]
    m = l.shape[0]

    is_eq = (u - l) < 1e-12
    # active flags: -1 at lower, +1 at upper, 0 inactive
    state = np.where(is_eq, 1, 0).astype(np.int8)

    z = np.zeros(n)
    y = np.zeros(m)
    prev_states = []
    for _ in range(max_iter):
        act = state != 0
        b = np.where(state > 0, u, l)[act]
        Aw = A[act]
        k = Aw.shape[0]
        K = np.block([[P, Aw.T], [Aw, np.zeros((k, k))]])
        rhs = np.concatenate([-q, b])
        try:
            sol = np.linalg.solve(K, rhs)
        except np.linalg.LinAlgError:
            # degenerate working set (dependent rows): tiny regularization
            sol = np.linalg.lstsq(K, rhs, rcond=None)[0]
        z = sol[:n]
        y = np.zeros(m)
        y[act] = sol[n:]

        Az = A @ z
        viol_u = Az > u + tol
        viol_l = Az < l - tol
        # wrong-sign duals leave the set; violated bounds enter it
        new_state = state.copy()
        new_state[(state > 0) & ~is_eq & (y < -tol)] = 0
        new_state[(state < 0) & (y > tol)] = 0
        new_state[viol_u & (state == 0)] = 1
        new_state[viol_l & (state == 0)] = -1
        new_state[is_eq] = 1

        if np.array_equal(new_state, state):
            break
        # cycle guard: if the working set repeats, perturb by keeping the
        # most-violated change only
        sig = new_state.tobytes()
        if sig in prev_states:
            diff = np.nonzero(new_state != state)[0]
            keep = diff[np.argmax(np.abs(np.where(
                new_state[diff] > 0, Az[diff] - u[diff],
                l[diff] - Az[diff])))]
            tmp = state.copy()
            tmp[keep] = new_state[keep]
            new_state = tmp
        prev_states.append(sig)
        state = new_state

    stat, prim, comp = kkt_residuals_f64(P, q, A, l, u, z, y)
    if max(stat, prim, comp) > 1e-7 * max(1.0, np.max(np.abs(q))):
        raise QPRefError(
            f"uncertified: stat={stat:.2e} prim={prim:.2e} comp={comp:.2e}")
    return z, y
