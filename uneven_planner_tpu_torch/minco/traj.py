"""SE(2) trajectory evaluation and post-solve metrics (port of
`uneven_planner_tpu/minco/traj.py`; se2traj.hpp:408-562 and the constraint
report ALMTrajOpt::getMaxVxAxAyCurAttSig, alm_traj_opt.h:170-229).

Batched over trajectories: coefficients are [B, Npieces, 6, Dim] physical
ascending-power coefficients and piece times [B, Npieces]; times are
[B, T].  Metrics sample on a masked fixed-size grid."""

from __future__ import annotations

from typing import NamedTuple

import torch

from uneven_planner_tpu_torch.minco import minco
from uneven_planner_tpu_torch.terrain import grid as tgrid

DELTA_V = 0.01      # se2traj.hpp:18 (curvature regularizer)
DELTA_SIGL = 0.01   # alm_traj_opt.h:16


class SE2Traj(NamedTuple):
    """Piecewise-quintic SE(2) trajectories (xy and yaw pieces share the
    total duration but may differ in count, se2traj.hpp:819-830)."""
    c_xy: torch.Tensor    # [B, Nxy, 6, 2]
    ts_xy: torch.Tensor   # [B, Nxy]
    c_yaw: torch.Tensor   # [B, Nyaw, 6, 1]
    ts_yaw: torch.Tensor  # [B, Nyaw]

    @property
    def total_duration(self) -> torch.Tensor:
        return torch.minimum(self.ts_xy.sum(-1), self.ts_yaw.sum(-1))


def se2_state(traj: SE2Traj, t: torch.Tensor):
    """(pos [B, T, 2], vel, acc, yaw [B, T], dyaw, d2yaw) at global times
    t [B, T]."""
    pos, vel, acc, _ = minco.eval_traj(traj.c_xy, traj.ts_xy, t)
    yaw, dyaw, d2yaw, _ = minco.eval_traj(traj.c_yaw, traj.ts_yaw, t)
    return pos, vel, acc, yaw[..., 0], dyaw[..., 0], d2yaw[..., 0]


def se2_pos(traj: SE2Traj, t: torch.Tensor) -> torch.Tensor:
    """[B, T, 3] poses (x, y, yaw)."""
    pos, _, _, yaw, _, _ = se2_state(traj, t)
    return torch.cat([pos, yaw[..., None]], dim=-1)


def lon_lat_acc(acc, yaw):
    """Longitudinal / lateral body-frame acceleration (se2traj.hpp:471-483)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return (acc[..., 0] * c + acc[..., 1] * s,
            -acc[..., 0] * s + acc[..., 1] * c)


def curvature(vel, yaw, dyaw):
    """Signed curvature with the reference's low-speed guard and direction
    sign eta (se2traj.hpp:485-498)."""
    v2 = (vel * vel).sum(-1)
    along = vel[..., 0] * torch.cos(yaw) + vel[..., 1] * torch.sin(yaw)
    eta = torch.where(along < 0, -1.0, 1.0)
    cur = dyaw / (eta * torch.sqrt(v2 + DELTA_V))
    return torch.where(torch.sqrt(v2) < 1e-4, 0.0, cur)


def _sample_times(traj: SE2Traj, num_samples: int, dt: float = 0.01):
    """Masked absolute-dt sampling grid: t = 0, dt, 2dt, ... < duration
    (se2traj.hpp:514,554; alm_traj_opt.h:184): (t [B, T], mask [B, T])."""
    t = torch.arange(num_samples, dtype=traj.ts_xy.dtype,
                     device=traj.ts_xy.device) * dt
    t = t.expand(traj.ts_xy.shape[0], num_samples)
    return t, t < traj.total_duration[:, None]


def non_hol_error(traj: SE2Traj, num_samples: int = 4096) -> torch.Tensor:
    """[B] sum over samples of |v . (sin yaw, -cos yaw)|
    (SE2Trajectory::getNonHolError, se2traj.hpp:551-561)."""
    t, mask = _sample_times(traj, num_samples)
    _, vel, _, yaw, _, _ = se2_state(traj, t)
    err = torch.abs(vel[..., 0] * torch.sin(yaw) - vel[..., 1] * torch.cos(yaw))
    return (err * mask).sum(-1)


def max_metrics(traj: SE2Traj, grid: tgrid.TerrainGrid,
                num_samples: int = 4096) -> dict:
    """Post-solve report per trajectory {max |vx|, max |ax|, max |ay|,
    max |kappa|, min cos_xi, max sigma}, each [B]
    (ALMTrajOpt::getMaxVxAxAyCurAttSig, alm_traj_opt.h:170-229)."""
    t, mask = _sample_times(traj, num_samples)
    pos, vel, acc, yaw, dyaw, _ = se2_state(traj, t)
    se2 = torch.stack([pos[..., 0], pos[..., 1], tgrid.normalize_so2(yaw)],
                      dim=-1)
    v = tgrid.get_terrain_variables_batch(grid, se2.reshape(-1, 3)) \
        .reshape(t.shape + (7,))
    inv_cos_vphix, sin_phix = v[..., 0], v[..., 1]
    inv_cos_vphiy, sin_phiy = v[..., 2], v[..., 3]
    cos_xi, inv_cos_xi, sigma = v[..., 4], v[..., 5], v[..., 6]
    la, lata = lon_lat_acc(acc, yaw)
    vx = torch.sqrt((vel * vel).sum(-1)) * inv_cos_vphix
    ax = la * inv_cos_vphix + grid.gravity * sin_phix
    ay = lata * inv_cos_vphiy + grid.gravity * sin_phiy
    cur = dyaw * inv_cos_xi / torch.sqrt(vx * vx + DELTA_SIGL)
    inf = float("inf")
    hi = lambda a: torch.where(mask, a, -inf).amax(-1)
    return {"max_vx": hi(torch.abs(vx)), "max_ax": hi(torch.abs(ax)),
            "max_ay": hi(torch.abs(ay)), "max_cur": hi(torch.abs(cur)),
            "min_cxi": torch.where(mask, cos_xi, inf).amin(-1),
            "max_sig": hi(sigma)}


def max_vel_rate(traj: SE2Traj, num_samples: int = 4096) -> torch.Tensor:
    """[B] max ||v|| by dense sampling (the reference isolates polynomial
    roots for the same diagnostic, se2traj.hpp:152-201)."""
    t, mask = _sample_times(traj, num_samples)
    vel = se2_state(traj, t)[1]
    return torch.where(mask, torch.sqrt((vel * vel).sum(-1)),
                       -float("inf")).amax(-1)


def sample_dense(traj: SE2Traj, num_samples: int, dt: float):
    """[B, num_samples, 3] SE(2) poses at t = i*dt (clamped to the duration)
    and a validity mask (alm_traj_opt.cpp:1068-1140)."""
    t = torch.arange(num_samples, dtype=traj.ts_xy.dtype,
                     device=traj.ts_xy.device) * dt
    dur = traj.total_duration[:, None]
    return se2_pos(traj, torch.minimum(t, dur)), t <= dur
