"""Evaluation of piecewise-quintic MINCO trajectories (port of `locate_piece`
and `eval_traj` of `uneven_planner_tpu/minco/minco.py`; the general
`generate` and `jerk_cost` are not ported yet: the solver builds its
coefficients with `minco/uniform.py`).

Coefficient layout: c[b, i, k, d] = coefficient of t^k (ascending) of piece
i, dimension d, of trajectory b.
"""

from __future__ import annotations

import torch

from uneven_planner_tpu_torch.kernels.gather import gather_along, gather_rows


def _beta(t: torch.Tensor):
    """Basis rows beta0..beta3 at times t [...]: value / velocity /
    acceleration / jerk weights [..., 6] of (1, t, ..., t^5)."""
    o, l = torch.zeros_like(t), torch.ones_like(t)
    t2, t3, t4 = t ** 2, t ** 3, t ** 4
    return (torch.stack([l, t, t2, t3, t4, t ** 5], -1),
            torch.stack([o, l, 2 * t, 3 * t2, 4 * t3, 5 * t4], -1),
            torch.stack([o, o, 2 * l, 6 * t, 12 * t2, 20 * t3], -1),
            torch.stack([o, o, o, 6 * l, 24 * t, 60 * t2], -1))


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
    return tuple(torch.einsum("btk,btkd->btd", b, c_i) for b in _beta(s))
