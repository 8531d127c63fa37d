"""Compact trajectory wire format and controller-side reconstruction (port
of `uneven_planner_tpu/mpc/traj_msg.py`).

The reference planner publishes trajectories as waypoints + piece times
(mpc_controller/msg/SE2Traj.msg:1-9, packed in plan_manager.cpp:150-185) and
the controller re-solves the MINCO system from that message to recover the
polynomial (TrajAnalyzer::setTraj, traj_anal.hpp:125-181).  Also the
figure-eight test trajectory of the controller's standalone test mode
(setTestTraj, traj_anal.hpp:447-483).

Every field carries a leading trajectory dimension, as `SE2Traj` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.minco import minco
from uneven_planner_tpu_torch.minco.traj import SE2Traj


class SE2TrajMsg(NamedTuple):
    """Wire format (SE2Traj.msg): piece-start waypoints + goal, durations,
    boundary velocity/acceleration."""
    pos_pts: torch.Tensor    # [B, Nxy+1, 2]
    pos_ts: torch.Tensor     # [B, Nxy]
    angle_pts: torch.Tensor  # [B, Nyaw+1, 1]
    angle_ts: torch.Tensor   # [B, Nyaw]
    init_v: torch.Tensor     # [B, 2]
    init_a: torch.Tensor     # [B, 2]


def _knots(c: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """[B, N+1, Dim]: every piece's start and the last piece's end."""
    starts = minco.eval_piece(c, torch.zeros_like(ts))[0]
    end = minco.eval_piece(c[:, -1], ts[:, -1])[0]
    return torch.cat([starts, end[:, None]], dim=1)


def msg_from_traj(traj: SE2Traj) -> SE2TrajMsg:
    """Pack trajectories (plan_manager.cpp:150-185; the reference zeroes
    init_v/init_a in the message)."""
    zero = traj.ts_xy.new_zeros((traj.ts_xy.shape[0], 2))
    return SE2TrajMsg(
        pos_pts=_knots(traj.c_xy, traj.ts_xy), pos_ts=traj.ts_xy,
        angle_pts=_knots(traj.c_yaw, traj.ts_yaw), angle_ts=traj.ts_yaw,
        init_v=zero, init_a=zero)


def traj_from_msg(msg: SE2TrajMsg) -> SE2Traj:
    """Re-solve MINCO through the waypoints (setTraj, traj_anal.hpp:125-181:
    head = (wp0, init_v, init_a), tail = (wpN, 0, 0))."""
    z2 = torch.zeros_like(msg.init_v)
    z1 = z2[:, :1]
    head_xy = torch.stack([msg.pos_pts[:, 0], msg.init_v, msg.init_a], dim=1)
    tail_xy = torch.stack([msg.pos_pts[:, -1], z2, z2], dim=1)
    c_xy = minco.generate(msg.pos_pts[:, 1:-1], msg.pos_ts, head_xy, tail_xy)
    head_yaw = torch.stack([msg.angle_pts[:, 0], z1, z1], dim=1)
    tail_yaw = torch.stack([msg.angle_pts[:, -1], z1, z1], dim=1)
    c_yaw = minco.generate(msg.angle_pts[:, 1:-1], msg.angle_ts, head_yaw,
                           tail_yaw)
    return SE2Traj(c_xy=c_xy, ts_xy=msg.pos_ts, c_yaw=c_yaw,
                   ts_yaw=msg.angle_ts)


def figure_eight(max_vel: float, n_pieces: int = 16, radius: float = 1.2,
                 dtype=torch.float64, device=None) -> SE2Traj:
    """Figure-eight test trajectory for isolating the controller
    (setTestTraj, traj_anal.hpp:447-483), a batch of one.  The waypoints are
    built with numpy in float64 on the host and cast, so that both packages
    solve from the same bits."""
    dev = resolve_device(device)
    length = 2 * (2 * math.pi * radius)
    total_t = length / max_vel
    ts = np.linspace(0.0, 1.0, n_pieces + 1)
    x = radius * np.sin(2 * np.pi * ts)
    y = radius * np.sin(2 * np.pi * ts) * np.cos(2 * np.pi * ts)
    dx = np.gradient(x, ts)
    dy = np.gradient(y, ts)
    yaw = np.unwrap(np.arctan2(dy, dx))

    to = lambda a: torch.tensor(np.asarray(a, np.float64)[None], dtype=dtype,
                                device=dev)
    piece_t = torch.full((1, n_pieces), total_t / n_pieces, dtype=dtype,
                         device=dev)
    head_xy = to([[x[0], y[0]], [dx[0] / total_t, dy[0] / total_t],
                  [0.0, 0.0]])
    tail_xy = to([[x[-1], y[-1]], [dx[-1] / total_t, dy[-1] / total_t],
                  [0.0, 0.0]])
    c_xy = minco.generate(to(np.stack([x[1:-1], y[1:-1]], axis=1)), piece_t,
                          head_xy, tail_xy)
    c_yaw = minco.generate(to(yaw[1:-1, None]), piece_t,
                           to([[yaw[0]], [0.0], [0.0]]),
                           to([[yaw[-1]], [0.0], [0.0]]))
    return SE2Traj(c_xy=c_xy, ts_xy=piece_t, c_yaw=c_yaw, ts_yaw=piece_t)
