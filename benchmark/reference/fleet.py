"""Plain reference of one fleet tick: the figure-eight's reference points,
the tracking MPC's relinearised QPs solved to float64 precision, and the
plant step.

Written from the reference controller's definitions (mpc_controller's
mpc.cpp: cost :335-385, dynamics :387-447, input rates :449-472, input box
:474-511, relinearisation loop :797-841; traj_anal.hpp: the figure-eight
:447-483 and the reference points :485-573; the wheel plant of carsim),
in plain PyTorch and NumPy.  It imports nothing of the program.

`Arith(tf32=True)` is the control: the same arithmetic in float32 with
every matrix product's operands rounded to TF32 (10 mantissa bits), as
the tensor cores take them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.arith import Arith


# ---------------------------------------------------------------------------
# minimum-jerk trajectory (MINCO, s = 3): quintic pieces, C^4 at the inner
# waypoints, position / velocity / acceleration fixed at both ends
# ---------------------------------------------------------------------------

def _rows(t: float):
    """Value and derivatives 1..4 of (1, t, ..., t^5), [5, 6]."""
    r = np.zeros((5, 6))
    for d in range(5):
        for k in range(d, 6):
            r[d, k] = math.factorial(k) / math.factorial(k - d) * t ** (k - d)
    return r


def minimum_jerk(inner: np.ndarray, ts: np.ndarray, head: np.ndarray,
                 tail: np.ndarray) -> np.ndarray:
    """Coefficients [N, 6, D] (ascending powers of the piece's local time)
    of the piecewise quintic through `inner` [N-1, D] with piece times
    `ts` [N] and boundary (p, v, a) `head`, `tail` [3, D]: one dense
    float64 solve of the 6N conditions."""
    N = len(ts)
    M = np.zeros((6 * N, 6 * N))
    rhs = np.zeros((6 * N, inner.shape[1]))
    row = 0
    start = _rows(0.0)
    for d in range(3):
        M[row, :6] = start[d]
        rhs[row] = head[d]
        row += 1
    for i in range(N - 1):
        end = _rows(ts[i])
        c0, c1 = 6 * i, 6 * (i + 1)
        M[row, c0:c0 + 6] = end[0]
        rhs[row] = inner[i]
        row += 1
        M[row, c1:c1 + 6] = start[0]
        rhs[row] = inner[i]
        row += 1
        for d in range(1, 5):
            M[row, c0:c0 + 6] = end[d]
            M[row, c1:c1 + 6] = -start[d]
            row += 1
    end = _rows(ts[-1])
    for d in range(3):
        M[row, 6 * (N - 1):] = end[d]
        rhs[row] = tail[d]
        row += 1
    return np.linalg.solve(M, rhs).reshape(N, 6, -1)


class Trajectory(NamedTuple):
    c_xy: torch.Tensor    # [N, 6, 2]
    c_yaw: torch.Tensor   # [N, 6, 1]
    ts: torch.Tensor      # [N]

    @property
    def duration(self) -> float:
        return float(self.ts.sum())


def figure_eight(max_vel: float, n_pieces: int, radius: float,
                 device="cpu") -> Trajectory:
    """The controller's figure-eight test trajectory (setTestTraj,
    traj_anal.hpp:447-483): 2 loops of `radius`, `n_pieces` equal pieces,
    at `max_vel` on average; float64."""
    total_t = 2 * (2 * math.pi * radius) / max_vel
    s = np.linspace(0.0, 1.0, n_pieces + 1)
    x = radius * np.sin(2 * np.pi * s)
    y = radius * np.sin(2 * np.pi * s) * np.cos(2 * np.pi * s)
    dx, dy = np.gradient(x, s), np.gradient(y, s)
    yaw = np.unwrap(np.arctan2(dy, dx))
    ts = np.full(n_pieces, total_t / n_pieces)
    c_xy = minimum_jerk(
        np.stack([x[1:-1], y[1:-1]], 1), ts,
        np.array([[x[0], y[0]], [dx[0] / total_t, dy[0] / total_t], [0, 0]]),
        np.array([[x[-1], y[-1]], [dx[-1] / total_t, dy[-1] / total_t],
                  [0, 0]]))
    c_yaw = minimum_jerk(yaw[1:-1, None], ts, np.array([[yaw[0]], [0], [0]]),
                         np.array([[yaw[-1]], [0], [0]]))
    to = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return Trajectory(to(c_xy), to(c_yaw), to(ts))


def _evaluate(c: torch.Tensor, ts: torch.Tensor, t: torch.Tensor):
    """Value [..., D] of the piecewise polynomial at global times t [...]:
    the piece whose span holds t (a time on a knot starts the next piece,
    a time past the end stays in the last)."""
    ends = torch.cumsum(ts, 0)
    idx = torch.searchsorted(ends, t.contiguous(), right=True).clamp(
        max=len(ts) - 1)
    local = t - torch.where(idx > 0, ends[(idx - 1).clamp(min=0)],
                            torch.zeros_like(t))
    powers = torch.stack([local ** k for k in range(6)], -1)   # [..., 6]
    return torch.einsum("...k,...kd->...d", powers, c[idx])


def reference_points(traj: Trajectory, t_now: torch.Tensor, steps: int,
                     dt: float):
    """Poses [S, 3, steps] at t_now + k dt, clamped at the end, and the
    at-goal flag [S] (one second past the end), float64."""
    t = t_now.double()[:, None] + dt * torch.arange(
        steps, dtype=torch.float64, device=t_now.device)
    t = torch.clamp(t, max=traj.duration)
    xy = _evaluate(traj.c_xy.to(t.device), traj.ts.to(t.device), t)
    yaw = _evaluate(traj.c_yaw.to(t.device), traj.ts.to(t.device), t)[..., 0]
    refs = torch.stack([xy[..., 0], xy[..., 1], yaw], 1)
    return refs, t_now.double() > traj.duration + 1.0


def _toward(d: torch.Tensor) -> torch.Tensor:
    """The controller's two wrap loops (mpc.h:142-153): subtract 2 pi while
    d >= pi/2, then add 2 pi while d <= -pi/2."""
    while bool((d >= math.pi / 2).any()):
        d = torch.where(d >= math.pi / 2, d - 2 * math.pi, d)
    while bool((d <= -math.pi / 2).any()):
        d = torch.where(d <= -math.pi / 2, d + 2 * math.pi, d)
    return d


def unwrap_yaw(refs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Reference yaws unwrapped step by step toward the current heading."""
    th = theta + _toward(refs[:, 2, 0] - theta)
    out = [th]
    for k in range(1, refs.shape[-1]):
        th = th + _toward(refs[:, 2, k] - th)
        out.append(th)
    return torch.cat([refs[:, :2], torch.stack(out, -1)[:, None]], 1)


# ---------------------------------------------------------------------------
# the MPC
# ---------------------------------------------------------------------------

def _turn_rate(v, u2, mpc: dict):
    if mpc["model_type"] == 1:           # differential drive: u2 is omega
        return u2
    return v / mpc["wheel_base"] * torch.tan(u2)


def rollout(state: torch.Tensor, output: torch.Tensor, mpc: dict):
    """The nonlinear model's states [S, T+1, 3] under `output` [S, 2, T],
    with the inputs clipped to their box (stateTrans, mpc.cpp:231-260)."""
    hi = mpc["max_omega"] if mpc["model_type"] == 1 else mpc["max_steer"]
    xs = [state]
    for k in range(output.shape[-1]):
        v = output[:, 0, k].clamp(mpc["min_speed"], mpc["max_speed"])
        u2 = output[:, 1, k].clamp(-hi, hi)
        x = xs[-1]
        xs.append(torch.stack([
            x[:, 0] + v * torch.cos(x[:, 2]) * mpc["dt"],
            x[:, 1] + v * torch.sin(x[:, 2]) * mpc["dt"],
            x[:, 2] + _turn_rate(v, u2, mpc) * mpc["dt"]], -1))
    return torch.stack(xs, 1)


def linear_model(theta, v, u2, mpc: dict):
    """x+ = A x + B u + C of the model about (theta, v, u2), each [S]:
    A [S, 3, 3], B [S, 3, 2], C [S, 3] (getLinearModel, mpc.cpp:194-229)."""
    dt = mpc["dt"]
    c, s = torch.cos(theta), torch.sin(theta)
    S = theta.shape[0]
    A = torch.eye(3, dtype=theta.dtype, device=theta.device).repeat(S, 1, 1)
    A[:, 0, 2] = -v * s * dt
    A[:, 1, 2] = v * c * dt
    B = theta.new_zeros((S, 3, 2))
    B[:, 0, 0] = c * dt
    B[:, 1, 0] = s * dt
    C = theta.new_zeros((S, 3))
    C[:, 0] = v * s * dt * theta
    C[:, 1] = -v * c * dt * theta
    if mpc["model_type"] == 1:
        B[:, 2, 1] = dt
    else:
        L = mpc["wheel_base"]
        B[:, 2, 0] = dt * torch.tan(u2) / L
        B[:, 2, 1] = dt * v / (L * torch.cos(u2) ** 2)
        C[:, 2] = -B[:, 2, 1] * u2
    return A, B, C


def input_constraints(mpc: dict, H: int, dtype, device):
    """G [m, 2H], h [m] of the input box and the input-rate limits as
    G u <= h (u = (v_0, u2_0, v_1, ...))."""
    n = 2 * H
    hi = mpc["max_omega"] if mpc["model_type"] == 1 else mpc["max_steer"]
    rate = mpc["max_domega"] if mpc["model_type"] == 1 else mpc["max_dsteer"]
    eye = np.eye(n)
    diff = np.zeros((n - 2, n))
    diff[np.arange(n - 2), np.arange(n - 2) + 2] = 1.0
    diff[np.arange(n - 2), np.arange(n - 2)] = -1.0
    upper = np.tile([mpc["max_speed"], hi], H)
    lower = np.tile([mpc["min_speed"], -hi], H)
    r = np.tile([mpc["max_accel"] * mpc["dt"], rate * mpc["dt"]], H - 1)
    G = np.concatenate([eye, -eye, diff, -diff])
    h = np.concatenate([upper, -lower, r, r])
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return to(G), to(h)


def input_cost(mpc: dict, H: int, dtype, device):
    """Hessian [2H, 2H] of the input terms: R on each input, Rd on each
    step's change, and Q's third weight on the speed (tracking a zero
    reference speed)."""
    R, Rd, Q = mpc["matrix_r"], mpc["matrix_rd"], mpc["matrix_q"]
    n = 2 * H
    W = np.diag(np.tile([R[0] + Q[2], R[1]], H))
    diff = np.zeros((n - 2, n))
    diff[np.arange(n - 2), np.arange(n - 2) + 2] = 1.0
    diff[np.arange(n - 2), np.arange(n - 2)] = -1.0
    Wd = np.diag(np.tile([Rd[0], Rd[1]], H - 1))
    return torch.as_tensor(2 * (W + diff.T @ Wd @ diff), dtype=dtype,
                           device=device)


def solve_qp(P, q, G, h, ar: Arith, iters: int = 60, tol: float = 1e-12):
    """min 1/2 u'Pu + q'u subject to G u <= h, for every lane: a
    primal-dual interior-point method (Mehrotra's predictor-corrector).
    P [S, n, n], q [S, n], G [m, n], h [m]."""
    S, n = q.shape
    m = G.shape[0]
    Gt = G.t()
    u = q.new_zeros((S, n))
    s = (h - ar.mm(u, Gt)).clamp(min=1.0)
    z = torch.ones_like(s)
    scale = 1.0 + q.abs().amax(-1, keepdim=True)
    for _ in range(iters):
        rd = ar.mm(P, u[..., None])[..., 0] + q + ar.mm(z, G)
        rp = ar.mm(u, Gt) + s - h
        mu = (s * z).sum(-1, keepdim=True) / m
        if float(torch.maximum(rd.abs().amax(-1, keepdim=True) / scale,
                               torch.maximum(rp.abs().amax(-1, keepdim=True),
                                             mu)).max()) < tol:
            break
        w = z / s
        K = P + ar.mm(Gt * w[:, None, :], G)
        L, info = torch.linalg.cholesky_ex(K)

        def newton(rc):
            rhs = -rd - ar.mm(w * rp - rc / s, G)
            du = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            gdu = ar.mm(du, Gt)
            dz = w * (gdu + rp) - rc / s
            # a lane whose factorisation broke down takes no step
            keep = (info == 0)[:, None]
            zero = lambda a: torch.where(keep & torch.isfinite(a), a,
                                         torch.zeros_like(a))
            return zero(du), zero(-rp - gdu), zero(dz)

        def step(ds, dz):
            a = torch.ones_like(mu)
            for v, dv in ((s, ds), (z, dz)):
                ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, 1e30))
                a = torch.minimum(a, ratio.amin(-1, keepdim=True))
            return a

        du, ds, dz = newton(s * z)
        a = step(ds, dz)
        mu_aff = ((s + a * ds) * (z + a * dz)).sum(-1, keepdim=True) / m
        sigma = (mu_aff / mu) ** 3
        du, ds, dz = newton(s * z + ds * dz - sigma * mu)
        a = 0.99 * step(ds, dz)
        a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
        u, s, z = u + a * du, s + a * ds, z + a * dz
    return u


def mpc_command(state, output, refs, mpc: dict, passes: int, ar: Arith):
    """The relinearisation loop of one tick (getCmd, mpc.cpp:797-841) with
    exact QP solves: state [S, 3], output [S, 2, T] the inputs carried from
    the previous tick, refs [S, 3, T] unwrapped.  Returns the command
    [S, 2] and the new output."""
    dt_ = ar.dtype
    state, output, refs = state.to(dt_), output.to(dt_), refs.to(dt_)
    S, _, T = output.shape
    H = T
    dev = state.device
    G, h = input_constraints(mpc, H, dt_, dev)
    Pu = input_cost(mpc, H, dt_, dev)
    Qx = torch.as_tensor(mpc["matrix_q"], dtype=dt_, device=dev).repeat(H)
    xr = refs.transpose(1, 2).reshape(S, 3 * H)
    done = torch.zeros(S, dtype=torch.bool, device=dev)
    for k in range(passes):
        if k > 0 and bool(done.all()):
            break
        xbar = rollout(state, output, mpc)
        A, B, C = linear_model(xbar[:, :H, 2].reshape(-1),
                               output[:, 0].reshape(-1),
                               output[:, 1].reshape(-1), mpc)
        A, B, C = (a.reshape((S, H) + a.shape[1:]) for a in (A, B, C))
        # states x_1..x_H as an affine map of the inputs: x = F u + w
        F = state.new_zeros((S, 3 * H, 2 * H))
        w = state.new_zeros((S, 3 * H))
        Fj = state.new_zeros((S, 3, 2 * H))
        wj = state
        for j in range(H):
            Fj = ar.mm(A[:, j], Fj)
            Fj[:, :, 2 * j:2 * j + 2] += B[:, j]
            wj = ar.mm(A[:, j], wj[..., None])[..., 0] + C[:, j]
            F[:, 3 * j:3 * j + 3] = Fj
            w[:, 3 * j:3 * j + 3] = wj
        Ft = F.transpose(1, 2)
        P = 2 * ar.mm(Ft, Qx[:, None] * F) + Pu
        q = 2 * ar.mm(Ft, (Qx * (w - xr))[..., None])[..., 0]
        u = solve_qp(P, q, G, h, ar)
        new = u.reshape(S, H, 2).transpose(1, 2)
        ok = torch.isfinite(new).all(-1).all(-1)
        new = torch.where(ok[:, None, None], new, output)
        live = ~done
        du = (new - output).abs().sum((-1, -2))
        output = torch.where(live[:, None, None], new, output)
        done = done | (live & (du <= mpc["du_threshold"]))
    return output[:, :, 0], output


def plant(state, cmd, mpc: dict, ctrl_dt: float):
    """The kinematic plant over one control period under cmd (v, u2)."""
    v, u2 = cmd[:, 0], cmd[:, 1]
    th = state[:, 2]
    return torch.stack([state[:, 0] + v * torch.cos(th) * ctrl_dt,
                        state[:, 1] + v * torch.sin(th) * ctrl_dt,
                        th + _turn_rate(v, u2, mpc) * ctrl_dt], -1)


def tick(traj: Trajectory, state, output, t_now, mpc: dict, passes: int,
         ctrl_dt: float, ar: Arith):
    """One tick of the reference fleet from the given lanes' state: (command
    [S, 2], next state [S, 3]), both in the arithmetic's dtype; the command
    is zero past the goal."""
    refs, at_goal = reference_points(traj, t_now, output.shape[-1],
                                     mpc["dt"])
    refs = unwrap_yaw(refs, state.double()[:, 2])
    cmd, _ = mpc_command(state, output, refs, mpc, passes, ar)
    cmd = torch.where(at_goal[:, None], torch.zeros_like(cmd), cmd)
    return cmd, plant(state.to(ar.dtype), cmd, mpc, ctrl_dt)
