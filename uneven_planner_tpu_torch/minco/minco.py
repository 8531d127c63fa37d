"""MINCO (s=3, minimum-jerk) trajectories with general piece times (port of
`uneven_planner_tpu/minco/minco.py`; reference MinJerkOpt / MINCO_SE2,
se2traj.hpp:564-870).  A trajectory with N pieces is the unique quintic
piecewise polynomial through N-1 inner waypoints with fixed boundary PVA and
C^4 continuity; `generate` gets its coefficients from one block-tridiagonal
solve and is a differentiable function of (inner points, piece times,
boundary states), so autograd through `generate` + `jerk_cost` takes the
place of the reference's hand-written gradient chain (se2traj.hpp:719-816).
The solver itself builds its coefficients with `minco/uniform.py`.

Everything is batched over trajectories.  Coefficient layout:
c[b, i, k, d] = coefficient of t^k (ascending) of piece i, dimension d, of
trajectory b.
"""

from __future__ import annotations

import torch

from uneven_planner_tpu_torch.kernels.gather import gather_along, gather_rows
from uneven_planner_tpu_torch.minco.banded import block_tridiag_solve


def _beta(t: torch.Tensor):
    """Basis rows beta0..beta3 at times t [...]: value / velocity /
    acceleration / jerk weights [..., 6] of (1, t, ..., t^5)."""
    o, l = torch.zeros_like(t), torch.ones_like(t)
    t2, t3, t4 = t ** 2, t ** 3, t ** 4
    return (torch.stack([l, t, t2, t3, t4, t ** 5], -1),
            torch.stack([o, l, 2 * t, 3 * t2, 4 * t3, 5 * t4], -1),
            torch.stack([o, o, 2 * l, 6 * t, 12 * t2, 20 * t3], -1),
            torch.stack([o, o, o, 6 * l, 24 * t, 60 * t2], -1))


def generate(inner: torch.Tensor, ts: torch.Tensor, head: torch.Tensor,
             tail: torch.Tensor) -> torch.Tensor:
    """Solve for the coefficients (MinJerkOpt::generate,
    se2traj.hpp:595-680).

    inner [B, N-1, Dim] inner waypoints, ts [B, N] piece durations, head and
    tail [B, 3, Dim] boundary (pos; vel; acc) -> c [B, N, 6, Dim]."""
    B, N = ts.shape
    dim = head.shape[-1]
    if N < 2:
        raise ValueError("MINCO needs at least 2 pieces")
    b0, b1, b2, _ = _beta(ts)                           # each [B, N, 6]
    new = lambda *shape: ts.new_zeros((B, N) + shape)

    D = new(6, 6)
    # block 0 rows 0-2: head PVA rows (se2traj.hpp:612-614)
    D[:, 0, 0, 0] = 1.0
    D[:, 0, 1, 1] = 1.0
    D[:, 0, 2, 2] = 2.0
    # blocks 1..N-1 rows 0-2: continuity -I terms (se2traj.hpp:640,646,651)
    D[:, 1:, 0, 0] = -1.0
    D[:, 1:, 1, 1] = -1.0
    D[:, 1:, 2, 2] = -2.0
    # blocks 0..N-2 rows 3-5: jerk/snap continuity and waypoint rows
    # (se2traj.hpp:621-633)
    D[:, :-1, 3, 3] = 6.0
    D[:, :-1, 3, 4] = 24.0 * ts[:, :-1]
    D[:, :-1, 3, 5] = 60.0 * ts[:, :-1] ** 2
    D[:, :-1, 4, 4] = 24.0
    D[:, :-1, 4, 5] = 120.0 * ts[:, :-1]
    D[:, :-1, 5, :] = b0[:, :-1]
    # block N-1 rows 3-5: tail PVA rows (se2traj.hpp:656-670)
    D[:, -1, 3, :] = b0[:, -1]
    D[:, -1, 4, :] = b1[:, -1]
    D[:, -1, 5, :] = b2[:, -1]

    # super-diagonal: -6 / -24 jerk/snap continuity into the next piece
    U = new(6, 6)
    U[:, :-1, 3, 3] = -6.0
    U[:, :-1, 4, 4] = -24.0

    # sub-diagonal: position/velocity/acceleration continuity rows at the
    # end of the previous piece (se2traj.hpp:634-651)
    Lb = new(6, 6)
    Lb[:, 1:, 0, :] = b0[:, :-1]
    Lb[:, 1:, 1, :] = b1[:, :-1]
    Lb[:, 1:, 2, :] = b2[:, :-1]

    rhs = new(6, dim)
    rhs[:, 0, 0:3, :] = head
    rhs[:, :-1, 5, :] = inner
    rhs[:, -1, 3:6, :] = tail
    return block_tridiag_solve(Lb, D, U, rhs)


def jerk_cost(c: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """[B] closed-form integral of squared jerk (se2traj.hpp:697-710) of
    c [B, N, 6, Dim] with piece times ts [B, N]."""
    c3, c4, c5 = c[:, :, 3, :], c[:, :, 4, :], c[:, :, 5, :]
    T1 = ts
    T2 = T1 * T1
    T3 = T2 * T1
    T4 = T2 * T2
    T5 = T4 * T1
    dot = lambda a, b: (a * b).sum(-1)
    e = (36.0 * dot(c3, c3) * T1 + 144.0 * dot(c4, c3) * T2
         + 192.0 * dot(c4, c4) * T3 + 240.0 * dot(c5, c3) * T3
         + 720.0 * dot(c5, c4) * T4 + 720.0 * dot(c5, c5) * T5)
    return e.sum(-1)


def eval_piece(c_i: torch.Tensor, s: torch.Tensor):
    """(value, vel, acc, jerk), each [..., Dim], of pieces c_i [..., 6, Dim]
    at local times s [...] (Piece::getValue/getDotValue/getDDotValue,
    se2traj.hpp:106-150)."""
    return tuple(torch.einsum("...k,...kd->...d", b, c_i) for b in _beta(s))


def locate_piece(ts_cumsum: torch.Tensor, t: torch.Tensor):
    """Piece index and local time for global times t [B, T] given the
    cumulative piece times [B, N] (PolyTrajectory::locatePieceIdx,
    se2traj.hpp:343-361): t beyond the end stays in the last piece."""
    N = ts_cumsum.shape[1]
    idx = torch.searchsorted(ts_cumsum.contiguous(), t.contiguous(),
                             right=True).clamp(0, N - 1)
    before = gather_along(ts_cumsum.contiguous(), (idx - 1).clamp(min=0))
    return idx, t - torch.where(idx == 0, torch.zeros_like(t), before)


def eval_traj(c: torch.Tensor, ts: torch.Tensor, t: torch.Tensor):
    """(pos, vel, acc, jerk), each [B, T, Dim], at global times t [B, T] of
    the trajectories c [B, N, 6, Dim] with piece times ts [B, N]."""
    B, N, _, D = c.shape
    idx, s = locate_piece(torch.cumsum(ts, dim=1), t)
    lane = torch.arange(B, device=c.device)[:, None] * N
    c_i = gather_rows(c.reshape(B * N, 6 * D).contiguous(),
                      (lane + idx).reshape(-1)).reshape(B, -1, 6, D)
    return eval_piece(c_i, s)


# ----------------------------------------------------------------------------
# SE(2) pairing: independent xy / yaw piece counts, equal total time
# (MINCO_SE2, se2traj.hpp:819-870)
# ----------------------------------------------------------------------------

def generate_se2(inner_xy, ts_xy, head_xy, tail_xy,
                 inner_yaw, ts_yaw, head_yaw, tail_yaw):
    return (generate(inner_xy, ts_xy, head_xy, tail_xy),
            generate(inner_yaw, ts_yaw, head_yaw, tail_yaw))


def jerk_cost_se2(c_xy, ts_xy, c_yaw, ts_yaw):
    return jerk_cost(c_xy, ts_xy) + jerk_cost(c_yaw, ts_yaw)
