"""Batched dense ADMM QP solver (OSQP-equivalent operator splitting; port of
`uneven_planner_tpu/solver/admm_qp.py`).

The reference MPC solves its QP with OSQP (mpc.cpp:513-542, abs/rel tol
1e-6).  This is the same algorithm, ADMM with over-relaxation on

    min 1/2 z'Pz + q'z   s.t.  l <= Az <= u

for a batch of independent QPs (a leading lane dimension on every
argument): the explicit inverse of M = P + sigma I + A' diag(rho) A once per
(re)factorization, so that the x-update of an iteration is one product, and
the iteration loop in one hand-written kernel per call
(`kernels/admm.py:admm_iterations`, K6).  The MPC QP's P is strictly positive
definite, so the minimizer is unique and matches OSQP's to solver tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uneven_planner_tpu_torch.kernels import admm as kadmm
from uneven_planner_tpu_torch.kernels import ruiz as kruiz
from uneven_planner_tpu_torch.utils.profiling import read_host, span


class QPSolution(NamedTuple):
    x: torch.Tensor          # [B, n] primal
    y: torch.Tensor          # [B, m] dual
    iters: torch.Tensor      # [B] int32
    r_prim: torch.Tensor     # [B]
    r_dual: torch.Tensor     # [B]
    converged: torch.Tensor  # [B] bool


def _mv(M, v):
    return torch.matmul(M, v[..., None])[..., 0]


def _spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of SPD matrices [B, n, n] by Cholesky.  A lane whose
    matrix is not finite or not positive definite gets a NaN inverse (no
    exception: one bad lane must not stop the batch), which its caller
    detects on the solution."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    finite = torch.isfinite(M).all(-1).all(-1)
    L, info = torch.linalg.cholesky_ex(
        torch.where(finite[:, None, None], M, eye))
    ok = finite & (info == 0)
    # a failed factor holds garbage: keep it away from the triangular solves
    L = torch.where(ok[:, None, None], L, eye)
    inv = torch.cholesky_inverse(L)
    return torch.where(ok[:, None, None], inv, torch.full_like(inv, torch.nan))


def ruiz_equilibrate(P, q, A, l, u, iters: int = 10,
                     min_scale: float = 1e-4, max_scale: float = 1e4):
    """OSQP's modified Ruiz equilibration (OSQP 5.1): iteratively scale rows
    and columns of the KKT data by inverse sqrt inf-norms, plus a cost
    normalization c.  Returns (Pb, qb, Ab, lb, ub, D, E, c) with
      Pb = c D P D, qb = c D q, Ab = E A D, lb/ub = E l/u
    and the unscaling x = D xb, y = c^{-1} E yb.  On CPU tensors the plain
    twin below; on CUDA tensors the kernel K7, one launch
    (`kernels/ruiz.py`), or an exception."""
    if q.device.type == "cpu":
        return ruiz_equilibrate_twin(P, q, A, l, u, iters, min_scale,
                                     max_scale)
    return kruiz.ruiz_equilibrate(P, q, A, l, u, iters=iters,
                                  min_scale=min_scale, max_scale=max_scale)


def ruiz_equilibrate_twin(P, q, A, l, u, iters: int = 10,
                          min_scale: float = 1e-4, max_scale: float = 1e4):
    """Plain PyTorch version of K7 `ruiz_equilibrate`, any float dtype and
    device: ~34 operations over the batch an iteration."""
    B, n = q.shape
    m = l.shape[1]
    D = q.new_ones((B, n))
    E = q.new_ones((B, m))
    c = q.new_ones((B,))
    Pb, qb, Ab = P, q, A
    for _ in range(iters):
        # column norms of the [P; A] block for the x-variables
        col_p = Pb.abs().amax(1)
        col_a = Ab.abs().amax(1)
        dx = 1.0 / torch.sqrt(torch.clamp(torch.maximum(col_p, col_a),
                                          min_scale, max_scale))
        # row norms of A for the constraint rows
        de = 1.0 / torch.sqrt(torch.clamp(Ab.abs().amax(2), min_scale,
                                          max_scale))
        Pb = Pb * dx[:, :, None] * dx[:, None, :]
        qb = qb * dx
        Ab = Ab * de[:, :, None] * dx[:, None, :]
        D = D * dx
        E = E * de
        # cost scaling: mean column norm of P vs q norm (OSQP eq. 28)
        gamma = 1.0 / torch.clamp(
            torch.maximum(Pb.abs().amax(1).mean(-1), qb.abs().amax(-1)),
            min_scale, max_scale)
        Pb = Pb * gamma[:, None, None]
        qb = qb * gamma[:, None]
        c = c * gamma
    return Pb, qb, Ab, E * l, E * u, D, E, c


def kkt_residuals(P, q, A, l, u, x, y):
    """KKT residuals [B] of candidate solutions: stationarity, primal
    feasibility, complementary slackness (the cross-solver oracle)."""
    z = _mv(A, x)
    stat = (_mv(P, x) + q + _mv(A.transpose(1, 2), y)).abs().amax(-1)
    prim = (torch.clamp(z - u, min=0.0) + torch.clamp(l - z, min=0.0)) \
        .amax(-1)
    # complementarity: y+ pushes at u, y- pushes at l
    comp = torch.where(y > 0, (z - u) * y, (z - l) * y).abs().amax(-1)
    return stat, prim, comp


def _polish(P, q, A, l, u, x, y, delta: float = 1e-7):
    """OSQP-style solution polish (OSQP 5.2): detect the active set from the
    dual signs, solve the equality-KKT system restricted to it (masked dense
    KKT with -delta regularization on inactive rows), and keep the polished
    point only where it is finite and improves the KKT residuals."""
    B, m, n = A.shape
    act_l = y < -1e-12
    act_u = y > 1e-12
    act = act_l | act_u
    b = torch.where(act_l, l, u)
    mask = act.to(q.dtype)
    # [P  (MA)'] [x]   [-q ]
    # [MA  -(1-m) I] [nu] = [m b]   (inactive rows force nu_i = 0)
    MA = A * mask[:, :, None]
    eye_n = torch.eye(n, dtype=q.dtype, device=q.device)
    top = lambda Pn: torch.cat([Pn, MA.transpose(1, 2)], dim=2)
    K = torch.cat([top(P + delta * eye_n),
                   torch.cat([MA, -torch.diag_embed((1.0 - mask) + delta)],
                             dim=2)], dim=1)
    # unperturbed KKT operator for the refinement residual
    K0 = torch.cat([top(P),
                    torch.cat([MA, -torch.diag_embed(1.0 - mask)], dim=2)],
                   dim=1)
    rhs = torch.cat([-q, mask * b], dim=1)[..., None]
    # factor K once; the refinement solves reuse the LU (K is symmetric
    # indefinite, so LU rather than Cholesky)
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    sol = torch.linalg.lu_solve(LU, piv, rhs)
    # iterative refinement against the unregularized system (OSQP's
    # polish_refine_iter) washes out the delta perturbation
    for _ in range(3):
        sol = sol + torch.linalg.lu_solve(LU, piv, rhs - K0 @ sol)
    sol = sol[..., 0]
    x_p, nu = sol[:, :n], sol[:, n:]
    y_p = torch.where(act, nu, torch.zeros_like(nu))

    def score(x_, y_):
        s, p, comp = kkt_residuals(P, q, A, l, u, x_, y_)
        return torch.maximum(torch.maximum(s, p), comp)

    better = (score(x_p, y_p) < score(x, y)) \
        & torch.isfinite(x_p).all(-1) & torch.isfinite(y_p).all(-1)
    return (torch.where(better[:, None], x_p, x),
            torch.where(better[:, None], y_p, y))


class QPSetup(NamedTuple):
    """A batch of QPs ready for `kernels.admm.admm_iterations`: the scaled
    data with its factorization, the start state, and what `solve_qp` needs
    to unscale the result and to refactorize."""
    data: kadmm.ADMMData
    state: kadmm.ADMMState
    D: torch.Tensor        # [B, n]
    E: torch.Tensor        # [B, m]
    is_eq: torch.Tensor    # [B, m] equality rows (on the unscaled bounds)


def _factor(P, A, is_eq, rho_s, sigma: float):
    """rho vector [B, m] and the inverse of M = P + sigma I + A' diag(rho) A
    for the scalar rho_s [B]; equality rows get 1e3 * rho."""
    rho_vec = torch.where(is_eq, 1e3 * rho_s[:, None], rho_s[:, None])
    eye_n = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    M = P + sigma * eye_n \
        + torch.matmul(A.transpose(1, 2) * rho_vec[:, None, :], A)
    return rho_vec.contiguous(), _spd_inverse(M).contiguous()


def setup_qp(P, q, A, l, u, *, rho: float = 0.1, sigma: float = 1e-6,
             x0=None, y0=None, ruiz: bool = True) -> QPSetup:
    """Equilibrate, classify the rows, factorize and scale the warm start:
    everything `solve_qp` does before its iteration loop."""
    B, n = q.shape
    m = A.shape[1]
    # OSQP rho vector: equality rows (l == u) get 1e3 * rho, essential for
    # convergence on mixed equality/box constraint sets.  Classified on the
    # UNSCALED bounds: a near-equality inequality must not change class
    # through the equilibration magnitudes.
    is_eq = (u - l).abs() < 1e-12
    if ruiz:
        with span("up.qp.ruiz"):
            P, q, A, l, u, D, E, c = ruiz_equilibrate(P, q, A, l, u)
    else:
        D = q.new_ones((B, n))
        E = q.new_ones((B, m))
        c = q.new_ones((B,))
    cinv = 1.0 / c
    Dinv = 1.0 / D
    Einv = 1.0 / E
    # warm starts arrive unscaled (the previous tick's solution)
    x = q.new_zeros((B, n)) if x0 is None else Dinv * x0
    y = q.new_zeros((B, m)) if y0 is None else c[:, None] * Einv * y0
    z = torch.clamp(_mv(A, x), l, u)
    rho_vec, minv = _factor(P, A, is_eq, q.new_full((B,), rho), sigma)
    data = kadmm.ADMMData(
        P=P.contiguous(), q=q.contiguous(), A=A.contiguous(),
        l=l.contiguous(), u=u.contiguous(), rho_vec=rho_vec, minv=minv,
        Dinv=Dinv.contiguous(), Einv=Einv.contiguous(), cinv=cinv)
    return QPSetup(data, kadmm.initial_state(
        x.contiguous(), z.contiguous(), y.contiguous()), D, E, is_eq)


def solve_qp(P, q, A, l, u, *, rho: float = 0.1, sigma: float = 1e-6,
             alpha: float = 1.6, eps_abs: float = 1e-6,
             eps_rel: float = 1e-6, max_iter: int = 2000,
             x0=None, y0=None, ruiz: bool = True,
             adaptive_rho: bool = True, adaptive_rho_interval: int = 25,
             polish: bool = True,
             fixed_iters: Optional[int] = None) -> QPSolution:
    """Solve B QPs: P [B, n, n], q [B, n], A [B, m, n], l, u [B, m].

    ADMM iteration (OSQP 3):

      x~ = M^-1 (sigma x - q + A'(rho z - y))
      z~ = A x~
      x+ = alpha x~ + (1-alpha) x
      z+ = clip(alpha z~ + (1-alpha) z + y/rho, l, u)
      y+ = y + rho (alpha z~ + (1-alpha) z - z+)

    with OSQP's production machinery: modified Ruiz equilibration, the
    equality-row rho boost, periodic adaptive rho (with refactorization) and
    active-set polish.  Rows with l == u are handled by the same projection.
    Warm start through x0 / y0 (unscaled, as a previous solution is).
    Termination uses OSQP's unscaled residual criteria, per lane; a lane
    that is done is frozen.  `fixed_iters` bounds the iteration count below
    `max_iter` (the tracking loop's budget); the update sequence is the
    same.  On CUDA tensors the loop runs in the kernel K6, one launch per
    call (one per `adaptive_rho_interval` iterations with `adaptive_rho`).
    A CUDA call takes float32 or float64 at any shape: the kernel's
    instantiation is chosen by `kernels.admm.variant`, the shared-memory
    ones for float32 QPs that fit (the condensed tracking QP), the sparse
    one for the QPs whose nonzeros fit in shared memory (the full tracking
    QP, n = 150, m = 208, and the float64 condensed one) and the
    global-memory one for the rest.  The equilibration runs in the kernel
    K7, one launch a call (`kernels/ruiz.py`).  Spans: `up.qp.setup` (with
    adaptive rho also each rho update) with `up.qp.ruiz` under it,
    `up.qp.admm` around each launch, `up.qp.finish` (unscaling, polish)."""
    B = q.shape[0]
    with span("up.qp.setup"):
        data, state, D, E, is_eq = setup_qp(P, q, A, l, u, rho=rho,
                                            sigma=sigma, x0=x0, y0=y0,
                                            ruiz=ruiz)
    kw = dict(sigma=sigma, alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
              max_iter=max_iter)
    budget = max_iter if fixed_iters is None else fixed_iters
    if not adaptive_rho:
        with span("up.qp.admm"):
            state = kadmm.admm_iterations(data, state, n_iters=budget, **kw)
    else:
        # Periodic adaptive rho (OSQP 5.2 eq. 29): the rule looks at the
        # residuals of iteration `it` whenever it % interval == 0, which,
        # counting from 0, is the end of a segment of `interval` iterations.
        rho_s = q.new_full((B,), rho)
        ran = 0
        while ran < budget:
            seg = min(adaptive_rho_interval, budget - ran)
            with span("up.qp.admm"):
                state = kadmm.admm_iterations(data, state, n_iters=seg, **kw)
            ran += seg
            if read_host("solve_qp.done", state.done.all()):
                break
            # the rule and the refactorization it asks for
            with span("up.qp.setup"):
                ratio = torch.sqrt(
                    (state.r_prim / torch.clamp(state.prim_norm, min=1e-12))
                    / torch.clamp(state.r_dual
                                  / torch.clamp(state.dual_norm, min=1e-12),
                                  min=1e-12))
                rho_prop = torch.clamp(rho_s * ratio, 1e-6, 1e6)
                adapt = (state.it % adaptive_rho_interval == 0) \
                    & ((rho_prop > 5.0 * rho_s) | (rho_prop < rho_s / 5.0)) \
                    & ~state.done
                if read_host("solve_qp.adapt", adapt.any()):
                    rho_s = torch.where(adapt, rho_prop, rho_s)
                    rv_new, mi_new = _factor(data.P, data.A, is_eq, rho_s,
                                             sigma)
                    data = data._replace(
                        rho_vec=torch.where(adapt[:, None], rv_new,
                                            data.rho_vec),
                        minv=torch.where(adapt[:, None, None], mi_new,
                                         data.minv))

    with span("up.qp.finish"):
        # unscale, then polish on the original data
        x_u = D * state.x
        y_u = data.cinv[:, None] * E * state.y
        if polish:
            x_u, y_u = _polish(P, q, A, l, u, x_u, y_u)
    return QPSolution(x=x_u, y=y_u, iters=state.it, r_prim=state.r_prim,
                      r_dual=state.r_dual, converged=state.it < max_iter)
