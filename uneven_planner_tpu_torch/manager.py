"""Init-guess construction (own copy of the host-side helpers of
`uneven_planner_tpu/manager.py`, plan_manager.cpp:43-189).

Takes an SE(2) init path, unwraps yaw, builds boundary PVA states with a
small tangential initial velocity, samples inner xy/yaw points at equal
arc-length fractions (fixed piece counts, so a batch shares one problem
shape) and sets the initial total time.  Pure numpy: results are numpy
arrays that the caller stacks and moves to the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from uneven_planner_tpu_torch.config import ManagerConfig
from uneven_planner_tpu_torch.solver.alm import Boundary


def _logC2_np(T: float) -> float:
    """tau = expC2^{-1}(T) in numpy (alm.logC2)."""
    if T > 1.0:
        return float(np.sqrt(max(2.0 * T - 1.0, 0.0)) - 1.0)
    return float(1.0 - np.sqrt(max(2.0 / max(T, 1e-12) - 1.0, 0.0)))


def _pack_np(tau: float, pxy: np.ndarray, pyaw: np.ndarray) -> np.ndarray:
    return np.concatenate([np.atleast_1d(np.float64(tau)),
                           np.asarray(pxy).reshape(-1),
                           np.asarray(pyaw).reshape(-1)])


def smooth_yaw_path(path: np.ndarray) -> np.ndarray:
    """Unwrap yaw along a path so consecutive differences stay within pi/2
    (plan_manager.cpp:62-77)."""
    out = path.copy()
    for i in range(len(out) - 1):
        dyaw = out[i + 1, 2] - out[i, 2]
        while dyaw >= np.pi / 2:
            out[i + 1, 2] -= 2 * np.pi
            dyaw = out[i + 1, 2] - out[i, 2]
        while dyaw <= -np.pi / 2:
            out[i + 1, 2] += 2 * np.pi
            dyaw = out[i + 1, 2] - out[i, 2]
    return out


def _arc_lengths(path: np.ndarray) -> np.ndarray:
    seg = np.linalg.norm(np.diff(path[:, :2], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def _interp_along(path: np.ndarray, arcs: np.ndarray,
                  targets: np.ndarray) -> np.ndarray:
    """Linear interpolation of (x, y, yaw) at given arc lengths."""
    out = np.empty((len(targets), 3))
    for d in range(3):
        out[:, d] = np.interp(targets, arcs, path[:, d])
    return out


def _boundary(path: np.ndarray, cfg: ManagerConfig) -> Boundary:
    """Boundary PVA with init_sig_vel tangential velocity
    (plan_manager.cpp:86-94); numpy arrays without a lane dimension."""
    y0, y1 = path[0, 2], path[-1, 2]
    head_xy = np.array([[path[0, 0], path[0, 1]],
                        [cfg.init_sig_vel * np.cos(y0),
                         cfg.init_sig_vel * np.sin(y0)],
                        [0.0, 0.0]])
    tail_xy = np.array([[path[-1, 0], path[-1, 1]],
                        [cfg.init_sig_vel * np.cos(y1),
                         cfg.init_sig_vel * np.sin(y1)],
                        [0.0, 0.0]])
    head_yaw = np.array([[y0], [0.0], [0.0]])
    tail_yaw = np.array([[y1], [0.0], [0.0]])
    return Boundary(head_xy=head_xy, tail_xy=tail_xy,
                    head_yaw=head_yaw, tail_yaw=tail_yaw)


def init_guess_fixed(path: np.ndarray, cfg: ManagerConfig,
                     piece_xy: int, piece_yaw: int
                     ) -> Tuple[np.ndarray, Boundary]:
    """Fixed-piece-count init guess for batched solving: inner points at
    equal arc-length fractions."""
    path = smooth_yaw_path(np.asarray(path, dtype=np.float64))
    arcs = _arc_lengths(path)
    total_len = arcs[-1]

    xy_targets = total_len * np.arange(1, piece_xy) / piece_xy
    yaw_targets = total_len * np.arange(1, piece_yaw) / piece_yaw
    inner_xy = _interp_along(path, arcs, xy_targets)[:, :2]
    inner_yaw = _interp_along(path, arcs, yaw_targets)[:, 2:3]

    total_time = total_len / cfg.mean_vel * cfg.init_time_times
    bound = _boundary(path, cfg)
    x0 = _pack_np(_logC2_np(total_time), inner_xy, inner_yaw)
    return np.asarray(x0), bound
