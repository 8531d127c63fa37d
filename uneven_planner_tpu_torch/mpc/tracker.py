"""Iterative-linearization tracking MPC with a batched ADMM QP (port of
`uneven_planner_tpu/mpc/tracker.py`; reference controller:
src/uneven_planner/mpc_controller/src/mpc.cpp).

Same QP as the reference: variables z = [states x_1..x_H ; inputs
u_0..u_{H-1}] (H = predict_steps - delay_num), quadratic tracking cost
(mpc.cpp:335-385), linearized dynamics equalities (:387-447), input-rate
inequalities (:449-472), input box bounds (:474-511), assembled densely
and solved by the batched ADMM QP (`solver/admm_qp.py`); by default the
states are eliminated exactly (`assemble_qp_condensed`).  The
relinearization loop (getCmd, mpc.cpp:797-841) runs with the du threshold
and an iteration cap in place of the reference's wall-clock budget.
Supports the DIFF and ACKER models (getLinearModel, mpc.cpp:194-229) and
input-delay compensation through the output buffer (mpc.cpp:544-553,
835-839).

Every function carries a leading lane dimension B (one controller per
lane); the recursions over the horizon are Python loops with the lanes
vectorised.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from uneven_planner_tpu_torch.config import MPCConfig
from uneven_planner_tpu_torch.minco.traj import SE2Traj, se2_state
from uneven_planner_tpu_torch.solver import admm_qp
# IEEE division by a scalar (`_wrap_towards` floors a quotient, and on the GPU
# PyTorch would multiply by the reciprocal instead)
from uneven_planner_tpu_torch.terrain.grid import _div
from uneven_planner_tpu_torch.utils.profiling import read_host, span

DIFF = 1
ACKER = 2


# ---------------------------------------------------------------------------
# Model (mpc.cpp:194-246)
# ---------------------------------------------------------------------------

def linearize(theta, vx, delta, cfg: MPCConfig):
    """A [..., 3, 3], B [..., 3, 2], C [..., 3] of x+ = A x + B u + C about
    (theta, vx, delta), each [...]."""
    dt = cfg.dt
    ct, st = torch.cos(theta), torch.sin(theta)
    o, l = torch.zeros_like(theta), torch.ones_like(theta)
    b00, b10 = ct * dt, st * dt
    if cfg.model_type == DIFF:
        b20, b21 = o, o + dt
    else:
        b20 = _div(dt * torch.tan(delta), cfg.wheel_base)
        b21 = dt * vx / (cfg.wheel_base * torch.cos(delta) ** 2)
    B = torch.stack([torch.stack([b00, o], -1), torch.stack([b10, o], -1),
                     torch.stack([b20, b21], -1)], -2)
    a02, a12 = -b10 * vx, b00 * vx
    A = torch.stack([torch.stack([l, o, a02], -1),
                     torch.stack([o, l, a12], -1),
                     torch.stack([o, o, l], -1)], -2)
    C = torch.stack([-a02 * theta, -a12 * theta,
                     (-b21 * delta) if cfg.model_type == ACKER else o], -1)
    return A, B, C


def _clipped_rates(u_v, u_2, cfg: MPCConfig):
    """Clipped speed and heading increment per step of the inputs (v,
    omega-or-steer), any shape (stateTrans, mpc.cpp:231-246)."""
    vx = torch.clamp(u_v, cfg.min_speed, cfg.max_speed)
    if cfg.model_type == DIFF:
        dtheta = torch.clamp(u_2, -cfg.max_omega, cfg.max_omega) * cfg.dt
    else:
        delta = torch.clamp(u_2, -cfg.max_steer, cfg.max_steer)
        dtheta = _div(vx, cfg.wheel_base) * torch.tan(delta) * cfg.dt
    return vx, dtheta


def state_trans(state, u, cfg: MPCConfig):
    """Clipped nonlinear forward step (stateTrans, mpc.cpp:231-246):
    state [B, 3], u [B, 2] -> [B, 3]."""
    vx, dtheta = _clipped_rates(u[:, 0], u[:, 1], cfg)
    th = state[:, 2]
    return torch.stack([state[:, 0] + vx * torch.cos(th) * cfg.dt,
                        state[:, 1] + vx * torch.sin(th) * cfg.dt,
                        th + dtheta], dim=-1)


def predict_motion(now_state, output, cfg: MPCConfig):
    """Nonlinear rollout with the current output sequence (predictMotion,
    mpc.cpp:248-260): now_state [B, 3], output [B, 2, T] -> [B, T+1, 3].

    The same arithmetic as T calls of `state_trans`, element for element:
    the heading does not depend on the position, so its recursion runs
    first, the position increments are then formed for all steps at once,
    and only the two running sums stay sequential."""
    T = output.shape[-1]
    vx, dtheta = _clipped_rates(output[:, 0], output[:, 1], cfg)
    ths = [now_state[:, 2]]
    for k in range(T):
        ths.append(ths[-1] + dtheta[:, k])
    th = torch.stack(ths, dim=1)                          # [B, T+1]
    step = torch.stack([vx * torch.cos(th[:, :T]) * cfg.dt,
                        vx * torch.sin(th[:, :T]) * cfg.dt], dim=-1)
    ps = [now_state[:, :2]]
    for k in range(T):
        ps.append(ps[-1] + step[:, k])
    return torch.cat([torch.stack(ps, dim=1), th[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# QP assembly (mpc.cpp:322-511 / 556-752)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _on_device(make, cfg: MPCConfig, dtype, device):
    """`make(cfg)` (numpy arrays) as tensors, made once per configuration,
    dtype and device: a tick must not copy constants from the host."""
    return tuple(torch.as_tensor(a, dtype=dtype).to(device)
                 for a in make(cfg))


def _linearizations(xbar, output, cfg: MPCConfig):
    """As, Bs, Cs [B, H, ...] at xbar[j + d], j = 0..H-1."""
    d = cfg.delay_num
    H = cfg.predict_steps - d
    return linearize(xbar[:, d:d + H, 2], output[:, 0, d:], output[:, 1, d:],
                     cfg)


def _input_rows(cfg: MPCConfig, H: int, col0: int, nx: int):
    """Constant input-box and input-rate rows (mpc.cpp:449-511) of a QP
    whose inputs start at column `col0` of `nx`: (A_box [2H, nx], l, u,
    A_rate [2H-2, nx], l, u) as numpy."""
    dimu, mz = 2 * H, 2 * H - 2
    Ab = np.zeros((dimu, nx))
    Ab[np.arange(dimu), col0 + np.arange(dimu)] = 1.0
    in_hi = cfg.max_omega if cfg.model_type == DIFF else cfg.max_steer
    lb = np.tile([cfg.min_speed, -in_hi], H)
    ub = np.tile([cfg.max_speed, in_hi], H)
    Ar = np.zeros((mz, nx))
    r = np.arange(mz)
    Ar[r, col0 + r] = -1.0
    Ar[r, col0 + r + 2] = 1.0
    rate_hi = cfg.max_comega if cfg.model_type == DIFF else cfg.max_csteer
    ur = np.tile([cfg.max_cv, rate_hi], H - 1)
    return Ab, lb, ub, Ar, -ur, ur


def _input_block_np(cfg: MPCConfig, H: int):
    """Input-only Hessian block Pu [2H, 2H] (numpy): the u-rows of the
    reference Hessian (mpc.cpp:344-385), R + Rd difference-chain couplings,
    with Q[2] added to the v weight for the dref velocity-tracking term
    (mpc.cpp:363-369)."""
    Q, R, Rd = cfg.matrix_q, cfg.matrix_r, cfg.matrix_rd
    dimu = 2 * H
    diag = np.zeros(dimu)
    diag[0::2] = 2 * (R[0] + 2 * Rd[0] + Q[2])
    diag[1::2] = 2 * (R[1] + 2 * Rd[1])
    diag[0] = diag[dimu - 2] = 2 * (R[0] + Rd[0] + Q[2])
    diag[1] = diag[dimu - 1] = 2 * (R[1] + Rd[1])
    Pu = np.diag(diag)
    off_r = np.arange(2, dimu)
    off_v = np.where(off_r % 2 == 0, -2 * Rd[0], -2 * Rd[1])
    Pu[off_r, off_r - 2] = off_v
    Pu[off_r - 2, off_r] = off_v
    return Pu


def _input_block(cfg: MPCConfig, H: int, dref):
    """Pu [2H, 2H] and the gradient qu [B, 2H] of the input block, for
    dref [B, 2, T]."""
    d = cfg.delay_num
    qu = dref.new_zeros((dref.shape[0], 2 * H))
    qu[:, 0::2] = -2 * cfg.matrix_q[2] * dref[:, 0, d:]
    Pu = torch.as_tensor(_input_block_np(cfg, H), dtype=dref.dtype)
    return Pu.to(dref.device), qu


def _full_constants(cfg: MPCConfig):
    """The lane-independent part of `assemble_qp` as numpy: (P, A with the
    constant entries, l, u with the constant bounds)."""
    H = cfg.predict_steps - cfg.delay_num
    dimx, dimu = 3 * H, 2 * H
    nx = dimx + dimu
    P = np.zeros((nx, nx))
    P[:dimx, :dimx] = np.diag(np.tile(2 * np.asarray(cfg.matrix_q), H))
    P[dimx:, dimx:] = _input_block_np(cfg, H)
    Ab, lb, ub, Ar, lr, ur = _input_rows(cfg, H, dimx, nx)
    # dynamics rows: identity on x_{j+1}, -I on x_j (the lane-dependent
    # entries are written by assemble_qp)
    Ad = np.zeros((dimx, nx))
    Ad[np.arange(dimx), np.arange(dimx)] = 1.0
    Ad[np.arange(3, dimx), np.arange(dimx - 3)] = -1.0
    A = np.concatenate([Ab, Ad, Ar])
    zero = np.zeros(dimx)
    return (P, A, np.concatenate([lb, zero, lr]),
            np.concatenate([ub, zero, ur]))


def assemble_qp(xbar, output, xref, dref, cfg: MPCConfig):
    """Dense (P, q, A, l, u), each with a leading lane dimension, of the
    reference QP at the linearization points xbar (states [B, T+1, 3]) and
    output (inputs [B, 2, T]); xref [B, 3, T], dref [B, 2, T].

    Variable layout: [x_1..x_H (3H), u_0..u_{H-1} (2H)]; the reference's
    'states' are x_{delay+1}.. and inputs u_{delay}.., matching its
    delay-shifted indexing.  P is the same for every lane and every call: it
    comes back as a read-only view of a cached tensor."""
    d = cfg.delay_num
    H = cfg.predict_steps - d
    dimx, dimu = 3 * H, 2 * H
    nx = dimx + dimu
    Q = cfg.matrix_q
    B = xbar.shape[0]
    Pc, Ac, lc, uc = _on_device(_full_constants, cfg, xbar.dtype,
                                xbar.device)
    P = Pc.expand(B, nx, nx)

    # gradient (mpc.cpp:335-341)
    q = xbar.new_zeros((B, nx))
    for k in range(3):
        q[:, k:dimx:3] = -2 * Q[k] * xref[:, k, d:]
    q[:, dimx:nx:2] = -2 * Q[2] * dref[:, 0, d:]

    As, Bs, Cs = _linearizations(xbar, output, cfg)

    # dynamics equality rows (mpc.cpp:387-447): x_{j+1} - A_j x_j - B_j u_j
    # = C_j (the x_0 term moves to the right-hand side for j = 0)
    Amat = Ac.repeat(B, 1, 1)
    j = torch.arange(H, device=xbar.device)
    r0 = dimu + 3 * j
    cu = dimx + 2 * j
    Amat[:, r0 + 0, cu] = -Bs[:, :, 0, 0]
    Amat[:, r0 + 1, cu] = -Bs[:, :, 1, 0]
    if cfg.model_type == ACKER:
        Amat[:, r0 + 2, cu] = -Bs[:, :, 2, 0]
    Amat[:, r0 + 2, cu + 1] = -Bs[:, :, 2, 1]
    cx = 3 * (j[1:] - 1)
    Amat[:, r0[1:] + 0, cx + 2] = -As[:, 1:, 0, 2]
    Amat[:, r0[1:] + 1, cx + 2] = -As[:, 1:, 1, 2]

    b0 = torch.matmul(As[:, 0], xbar[:, d, :, None])[..., 0] + Cs[:, 0]
    bvec = torch.cat([b0, Cs[:, 1:].reshape(B, -1)], dim=1)
    l = lc.repeat(B, 1)
    u = uc.repeat(B, 1)
    l[:, dimu:dimu + dimx] = bvec
    u[:, dimu:dimu + dimx] = bvec
    return P, q, Amat, l, u


def _condensed_constants(cfg: MPCConfig):
    """The lane-independent part of `assemble_qp_condensed` as numpy:
    (Pu, A, l, u, sel [H, 2, 2H], Px [3H], Q [3])."""
    H = cfg.predict_steps - cfg.delay_num
    dimu = 2 * H
    Ab, lb, ub, Ar, lr, ur = _input_rows(cfg, H, 0, dimu)
    sel = np.zeros((H, 2, dimu))
    k = np.arange(H)
    sel[k, 0, 2 * k] = 1.0
    sel[k, 1, 2 * k + 1] = 1.0
    return (_input_block_np(cfg, H), np.concatenate([Ab, Ar]),
            np.concatenate([lb, lr]), np.concatenate([ub, ur]), sel,
            np.tile(2 * np.asarray(cfg.matrix_q), H),
            np.asarray(cfg.matrix_q))


def assemble_qp_condensed(xbar, output, xref, dref, cfg: MPCConfig):
    """Inputs-only condensed QP: exact elimination of the state variables.

    The reference QP (mpc.cpp:322-511) has NO state bounds: states appear
    only in the quadratic tracking cost and the linearized dynamics
    equalities.  Substituting x = F u + w (the linear dynamics response)
    eliminates them exactly, leaving n = 2H variables and 2H + (2H - 2)
    input box + input-rate rows, with the same unique u*.

      x_{k+1} = A_k x_k + B_k u_k + C_k,  x_0 = xbar[d]
      => P~ = F' Px F + Pu,  q~ = F' (Px w + qx) + qu

    The products are full float32 (the package allows no TF32).  A, l and u
    are the same for every lane and every call: they come back as read-only
    views of cached tensors."""
    d = cfg.delay_num
    H = cfg.predict_steps - d
    dimu = 2 * H
    B = xbar.shape[0]
    Pu, Ac, lc, uc, sel, Px, Qv = _on_device(
        _condensed_constants, cfg, xbar.dtype, xbar.device)
    As, Bs, Cs = _linearizations(xbar, output, cfg)

    # free response w_k and input response F_k, k = 1..H, carried together
    # as G_k = [w_k | F_k] [B, 3, 1 + 2H]:  G_{k+1} = A_k G_k + [C_k | B_k S_k]
    # with S_k the selector of u_k's two columns
    add = torch.cat([Cs[..., None],
                     torch.matmul(Bs, sel)], dim=-1)
    G = torch.cat([xbar[:, d, :, None], xbar.new_zeros((B, 3, dimu))], dim=-1)
    Gs = []
    for k in range(H):
        G = torch.matmul(As[:, k], G) + add[:, k]
        Gs.append(G)
    Gs = torch.stack(Gs, dim=1).reshape(B, 3 * H, 1 + dimu)
    w, F = Gs[:, :, 0], Gs[:, :, 1:]

    qx = (-2 * Qv[:, None] * xref[:, :, d:]).transpose(1, 2).reshape(B, -1)
    qu = xbar.new_zeros((B, dimu))
    qu[:, 0::2] = -2 * cfg.matrix_q[2] * dref[:, 0, d:]
    Ft = F.transpose(1, 2)
    P = torch.matmul(Ft, Px[:, None] * F) + Pu
    q = torch.matmul(Ft, (Px * w + qx)[..., None])[..., 0] + qu
    expand = lambda a: a.expand((B,) + a.shape)
    return P, q, expand(Ac), expand(lc), expand(uc)


# ---------------------------------------------------------------------------
# Relinearization loop (getCmd, mpc.cpp:797-841)
# ---------------------------------------------------------------------------

class MPCStepResult(NamedTuple):
    cmd: torch.Tensor           # [B, 2] (v, omega-or-steer)
    output: torch.Tensor        # [B, 2, T] full planned input sequence
    output_buff: torch.Tensor   # [B, max(delay, 1), 2] rotated delay buffer
    qp_iters: torch.Tensor      # [B] ADMM iterations over all passes
    sqp_iters: torch.Tensor     # [B] relinearization passes
    du: torch.Tensor            # [B]
    # diagnostics of the passes a lane ran
    qp_iters_max: Optional[torch.Tensor] = None   # [B] most in one pass
    qp_capped: Optional[torch.Tensor] = None  # [B] passes at the budget
    qp_failed: Optional[torch.Tensor] = None  # [B] non-finite solutions


def mpc_step(now_state, xref, dref, output_prev, output_buff,
             cfg: MPCConfig, max_sqp_iter: Optional[int] = None
             ) -> MPCStepResult:
    """One control tick per lane: relinearize and solve until
    du <= du_threshold or the pass cap.  now_state [B, 3], xref [B, 3, T],
    dref and output_prev [B, 2, T], output_buff [B, max(delay, 1), 2].
    The loop stops when every lane is done; a done lane is frozen.  On CUDA
    tensors the QP goes through the ADMM kernel in float32 or float64, the
    condensed QP (`cfg.qp_condense`, n = 2 (T - d)) and the full QP
    (`qp_condense=False`, n = 150, m = 208 at T = 30) alike.  Spans:
    `up.mpc_step`, one `up.mpc_step.pass` a pass with the assembly's
    `up.mpc_step.assemble` and `solve_qp`'s under it; the check that ends
    the loop early is a counted host read ("mpc_step.done")."""
    T, d = cfg.predict_steps, cfg.delay_num
    H = T - d
    dimx = 3 * H
    B = now_state.shape[0]
    dev = now_state.device
    max_sqp = max_sqp_iter if max_sqp_iter is not None else cfg.max_iter
    budget = cfg.qp_max_iter if cfg.qp_scan_iters is None \
        else cfg.qp_scan_iters

    def qp_pass(output, y_prev):
        with span("up.mpc_step.assemble"):
            xbar = predict_motion(now_state, output, cfg)
            if cfg.qp_condense:
                P, q, A, l, u = assemble_qp_condensed(xbar, output, xref,
                                                      dref, cfg)
                # warm start: previous inputs (primal), dual carried across
                # relinearizations (the OSQP warm start of mpc.cpp:518)
                x_ws = output[:, :, d:].transpose(1, 2).reshape(B, -1)
            else:
                P, q, A, l, u = assemble_qp(xbar, output, xref, dref, cfg)
                # primal from the nonlinear rollout (near-feasible for the
                # dynamics rows) + previous inputs
                x_ws = torch.cat([xbar[:, d + 1:].reshape(B, -1),
                                  output[:, :, d:].transpose(1, 2)
                                  .reshape(B, -1)], dim=1)
        sol = admm_qp.solve_qp(
            P, q, A, l, u, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
            alpha=cfg.qp_alpha, eps_abs=cfg.qp_abs_tol,
            eps_rel=cfg.qp_rel_tol, max_iter=cfg.qp_max_iter,
            x0=x_ws, y0=y_prev, polish=cfg.qp_polish,
            adaptive_rho=cfg.qp_adaptive_rho,
            fixed_iters=cfg.qp_scan_iters)
        xu = sol.x if cfg.qp_condense else sol.x[:, dimx:]
        un = xu.reshape(B, H, 2).transpose(1, 2)            # [B, 2, H]
        # solver-failure recovery (an OSQP failure silently keeps the
        # previous output, mpc.cpp:526-539): a non-finite QP solution, e.g.
        # from a failed factorization, must not poison the carried output
        ok = torch.isfinite(un).all(-1).all(-1)
        un = torch.where(ok[:, None, None], un, output[:, :, d:])
        y_out = torch.where(ok[:, None], sol.y, y_prev)
        parts = [output_buff[:, :d].transpose(1, 2)] if d > 0 else []
        return torch.cat(parts + [un], dim=2), sol.iters, y_out, ok

    with span("up.mpc_step"):
        nc = (4 * H - 2) if cfg.qp_condense else (2 * H + dimx + 2 * H - 2)
        izero = lambda: torch.zeros((B,), dtype=torch.int32, device=dev)
        output = output_prev
        y = now_state.new_zeros((B, nc))
        it, qp_iters, qp_max, capped, failed = (izero() for _ in range(5))
        du = now_state.new_full((B,), float("inf"))
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for k in range(max_sqp):
            if k > 0 and read_host("mpc_step.done", done.all()):
                break
            with span("up.mpc_step.pass"):
                out, qpi, y_new, ok = qp_pass(output, y)
                live = ~done
                du = torch.where(live, (out - output).abs().sum((-1, -2)), du)
                output = torch.where(live[:, None, None], out, output)
                y = torch.where(live[:, None], y_new, y)
                it = it + live.to(torch.int32)
                qp_iters = torch.where(live, qp_iters + qpi, qp_iters)
                qp_max = torch.where(live, torch.maximum(qp_max, qpi), qp_max)
                capped = capped + (live & (qpi >= budget)).to(torch.int32)
                failed = failed + (live & ~ok).to(torch.int32)
                done = done | (live & ((du <= cfg.du_threshold)
                                       | (it >= max_sqp)))

        cmd = output[:, :, d]
        if d > 0:
            new_buff = torch.cat([output_buff[:, 1:d], cmd[:, None, :],
                                  output_buff[:, d:]], dim=1)
        else:
            new_buff = output_buff
        return MPCStepResult(cmd=cmd, output=output, output_buff=new_buff,
                             qp_iters=qp_iters, sqp_iters=it, du=du,
                             qp_iters_max=qp_max, qp_capped=capped,
                             qp_failed=failed)


# ---------------------------------------------------------------------------
# Reference sampling + yaw smoothing (TrajAnalyzer::getRefPoints,
# traj_anal.hpp:485-573; smooth_yaw, mpc.h:140-169)
# ---------------------------------------------------------------------------

def get_ref_points(traj: SE2Traj, t_now, cfg: MPCConfig):
    """Reference poses [B, 3, T] at t_now + k*dt (clamped at the goal) of
    each lane's trajectory at its own time t_now [B], and the at_goal flag
    [B] (true past duration + 1 s)."""
    T = cfg.predict_steps
    dur = traj.total_duration
    steps = torch.arange(T, dtype=t_now.dtype, device=t_now.device) * cfg.dt
    ts = torch.minimum(t_now[:, None] + steps, dur[:, None])
    pos, _, _, yaw, _, _ = se2_state(traj, ts)
    refs = torch.stack([pos[..., 0], pos[..., 1], yaw], dim=1)
    return refs, t_now > dur + 1.0


def _wrap_towards(d):
    """Closed form of the reference's two sequential wrap loops
    (mpc.h:142-153): subtract 2pi while d >= pi/2, then add 2pi while
    d <= -pi/2."""
    two_pi = 2 * math.pi
    zero = torch.zeros_like(d)
    k = torch.where(d >= math.pi / 2,
                    torch.floor(_div(d - math.pi / 2, two_pi)) + 1.0, zero)
    d = d - two_pi * k
    mneg = torch.where(d <= -math.pi / 2,
                       torch.floor(_div(-d - math.pi / 2, two_pi)) + 1.0,
                       zero)
    return d + two_pi * mneg


def smooth_yaw(xref, now_theta):
    """Unwrap the reference yaw sequences xref[:, 2, :] toward the current
    headings now_theta [B]."""
    th = now_theta + _wrap_towards(xref[:, 2, 0] - now_theta)
    ths = [th]
    for k in range(1, xref.shape[-1]):
        th = th + _wrap_towards(xref[:, 2, k] - th)
        ths.append(th)
    return torch.cat([xref[:, :2], torch.stack(ths, dim=-1)[:, None]], dim=1)
