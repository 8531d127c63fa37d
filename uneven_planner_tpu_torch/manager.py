"""Init-guess construction (port of `uneven_planner_tpu/manager.py`,
plan_manager.cpp:43-189).

Takes an SE(2) init path, unwraps yaw, builds boundary PVA states with a
small tangential initial velocity, samples inner xy/yaw points by arc length
and sets the initial total time.  Three forms:

- `init_guess_from_path`: data-dependent piece counts, the reference's
  sampling (one problem instance; numpy);
- `init_guess_fixed`: fixed piece counts, inner points at equal arc-length
  fractions, so a batch shares one problem shape (numpy; the caller stacks
  the results and moves them to the device);
- `init_guess_fixed_device`: the same on tensors, for a batch of masked
  paths as the front end returns them, without leaving the device (the JAX
  package's `init_guess_fixed_jax`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from uneven_planner_tpu_torch.config import ManagerConfig
from uneven_planner_tpu_torch.kernels.gather import gather_along
from uneven_planner_tpu_torch.solver.alm import (Boundary, ProblemShape,
                                                 logC2, pack)
from uneven_planner_tpu_torch.terrain.grid import so2_diff


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


def init_guess_from_path(path: np.ndarray, cfg: ManagerConfig
                         ) -> Tuple[np.ndarray, Boundary, ProblemShape]:
    """Reference-style init guess: inner xy points every piece_len of arc
    length, yaw points every piece_len/yaw_piece_times
    (plan_manager.cpp:96-132)."""
    path = smooth_yaw_path(np.asarray(path, dtype=np.float64))
    arcs = _arc_lengths(path)
    total_len = arcs[-1]

    xy_targets = np.arange(cfg.piece_len, total_len, cfg.piece_len)
    # drop a final point that would coincide with the goal
    xy_targets = xy_targets[xy_targets < total_len - 1e-9]
    yaw_step = cfg.piece_len / cfg.yaw_piece_times
    yaw_targets = np.arange(yaw_step, total_len, yaw_step)
    yaw_targets = yaw_targets[yaw_targets < total_len - 1e-9]

    inner_xy = _interp_along(path, arcs, xy_targets)[:, :2]
    inner_yaw = _interp_along(path, arcs, yaw_targets)[:, 2:3]

    total_time = total_len / cfg.mean_vel * cfg.init_time_times
    shape = ProblemShape(piece_xy=len(inner_xy) + 1,
                         piece_yaw=len(inner_yaw) + 1, int_K=16)
    bound = _boundary(path, cfg)
    x0 = _pack_np(_logC2_np(total_time), inner_xy, inner_yaw)
    return np.asarray(x0), bound, shape


# ---------------------------------------------------------------------------
# On-device init guess for the plan -> optimize path
# ---------------------------------------------------------------------------

def _interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` for each row: x [B, T], xp and fp [B, L], xp
    non-decreasing.  Between two equal xp (the padded tail of a path) the
    left value is returned, and x outside [xp[0], xp[-1]] takes the end
    value, as in the JAX package's call."""
    L = xp.shape[1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True) \
        .clamp(1, L - 1)
    at = lambda a, j: gather_along(a, j)
    x0, x1, f0, f1 = at(xp, i - 1), at(xp, i), at(fp, i - 1), at(fp, i)
    dx = x1 - x0
    flat = torch.abs(dx) <= float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    f = torch.where(flat, f0,
                    f0 + ((x - x0) / torch.where(flat, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def init_guess_fixed_device(path: torch.Tensor, mask: torch.Tensor,
                            cfg: ManagerConfig, piece_xy: int,
                            piece_yaw: int) -> Tuple[torch.Tensor, Boundary]:
    """`init_guess_fixed` for a batch of masked paths on their device: path
    [B, L, 3], mask [B, L] (the front end's padded output) -> (x0 [B, n],
    Boundary of [B, ...]).  Compresses the valid rows, unwraps yaw,
    resamples inner points at equal arc-length fractions, builds boundary
    PVA and the packed decision vector.  A path with fewer than two valid
    rows (a failed search) yields finite values that mean nothing."""
    B, L, _ = path.shape
    dev, dtype = path.device, path.dtype
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True) \
        .to(torch.int32)
    n = mask.sum(dim=1, dtype=torch.int64).clamp(min=2)
    # valid rows first, the tail padded with the last valid row
    rows = gather_along(order, torch.minimum(
        torch.arange(L, device=dev).expand(B, L), n[:, None] - 1)
        .contiguous())
    px, py, pyaw = (gather_along(path[..., k].contiguous(), rows)
                    for k in range(3))

    # unwrap yaw along the path (smooth yaw, plan_manager.cpp:62-77)
    dyaw = so2_diff(pyaw[:, 1:], pyaw[:, :-1])
    yaw_un = torch.cat([pyaw[:, :1],
                        pyaw[:, :1] + torch.cumsum(dyaw, dim=1)], dim=1)
    dx, dy = px[:, 1:] - px[:, :-1], py[:, 1:] - py[:, :-1]
    seg = torch.sqrt(dx * dx + dy * dy)
    arcs = torch.cat([torch.zeros((B, 1), dtype=dtype, device=dev),
                      torch.cumsum(seg, dim=1)], dim=1)
    total_len = arcs[:, -1:]

    frac = lambda pieces: total_len * torch.arange(
        1, pieces, dtype=dtype, device=dev) / pieces
    fr_xy, fr_yaw = frac(piece_xy), frac(piece_yaw)
    inner_xy = torch.stack([_interp(fr_xy, arcs, px),
                            _interp(fr_xy, arcs, py)], dim=-1)
    inner_yaw = _interp(fr_yaw, arcs, yaw_un)[..., None]

    y0, y1 = yaw_un[:, 0], yaw_un[:, -1]
    sv = cfg.init_sig_vel
    zero = torch.zeros_like(y0)

    def pva_xy(x, y, yaw):
        return torch.stack([torch.stack([x, y], -1),
                            torch.stack([sv * torch.cos(yaw),
                                         sv * torch.sin(yaw)], -1),
                            torch.stack([zero, zero], -1)], dim=1)

    pva_yaw = lambda yaw: torch.stack([yaw, zero, zero], dim=1)[..., None]
    bound = Boundary(head_xy=pva_xy(px[:, 0], py[:, 0], y0),
                     tail_xy=pva_xy(px[:, -1], py[:, -1], y1),
                     head_yaw=pva_yaw(y0), tail_yaw=pva_yaw(y1))
    total_time = total_len[:, 0] / cfg.mean_vel * cfg.init_time_times
    return pack(logC2(total_time), inner_xy, inner_yaw), bound
