"""Carry state across from the JAX package: its arrays come in as numpy
arrays (`np.asarray(jax_array)`), port tensors come out.

For this system the "weights" are the terrain field with its gather tables
and the solver state (boundaries, duals, scalings).  The JAX package keeps
the tables channel-major ([8, Ncells] f32 pair table, [6, 2*Ncells] f32
words of the f16 table); the port keeps them row-major with 32-byte rows,
so conversion is a transpose (and an 8-word pad for the f16 table) with
the bits unchanged.  Front-end paths, search results and trajectories keep
their layout; the port's carry a leading scenario dimension, which a single
(un-vmapped) JAX result gets here.
"""

from __future__ import annotations

import numpy as np
import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.frontend.kino_init import KinoResult
from uneven_planner_tpu_torch.minco.traj import SE2Traj
from uneven_planner_tpu_torch.solver.alm import Boundary, DualState, Scaling
from uneven_planner_tpu_torch.terrain import grid as tgrid


def _t(a, device):
    return torch.tensor(np.asarray(a), device=device)


def grid_from_numpy(data, *, xy_resolution: float, yaw_resolution: float,
                    origin, occ, occ_xy=None, gravity: float = 9.81,
                    data_pair=None, data_packed16=None,
                    device=None) -> tgrid.TerrainGrid:
    """TerrainGrid from a numpy RXS2 field [Nx, Ny, Nyaw, 4], its geometry
    and occupancy, with both gather tables.

    `data_pair` ([8, Ncells]) and `data_packed16` ([6, 2*Ncells], f32 or
    uint32 words) in the JAX package's layout are converted when given; a
    table not given is built in the port."""
    dev = resolve_device(device)
    occ = np.asarray(occ)
    occ_xy = occ.any(axis=-1) if occ_xy is None else np.asarray(occ_xy)
    grid = tgrid.TerrainGrid(
        data=_t(data, dev), occ=_t(occ, dev), occ_xy=_t(occ_xy, dev),
        xy_resolution=float(xy_resolution),
        yaw_resolution=float(yaw_resolution),
        origin=tuple(float(o) for o in origin), gravity=float(gravity))
    if data_pair is not None:
        grid = grid.replace(data_pair=_t(np.asarray(data_pair).T, dev))
    else:
        grid = tgrid.with_pair_table(grid)
    if data_packed16 is not None:
        words = np.ascontiguousarray(np.asarray(data_packed16)) \
            .view(np.int32).T                            # [2*Ncells, 6]
        packed = np.zeros((words.shape[0], 8), np.int32)
        packed[:, :6] = words
        grid = grid.replace(data_packed16=_t(packed, dev))
    else:
        grid = tgrid.with_packed_f16(grid)
    return grid


def boundary_from_numpy(bound, device=None) -> Boundary:
    """Any object with head_xy / tail_xy / head_yaw / tail_yaw arrays
    (e.g. the JAX package's Boundary after np.asarray) -> port Boundary."""
    dev = resolve_device(device)
    return Boundary(*[_t(getattr(bound, f), dev) for f in Boundary._fields])


def duals_from_numpy(lam, mu, rho, device=None) -> DualState:
    dev = resolve_device(device)
    return DualState(lam=_t(lam, dev), mu=_t(mu, dev), rho=_t(rho, dev))


def scaling_from_numpy(scale_fx, scale_cx, device=None) -> Scaling:
    dev = resolve_device(device)
    return Scaling(scale_fx=_t(scale_fx, dev), scale_cx=_t(scale_cx, dev))


def _lanes(a, ndim: int, device) -> torch.Tensor:
    """numpy -> tensor, with a leading scenario dimension added when the
    array has `ndim - 1` dimensions (a single JAX result)."""
    a = np.asarray(a)
    return _t(a[None] if a.ndim == ndim - 1 else a, device)


def path_from_numpy(path, mask, device=None):
    """A padded front-end path [L, 3] or [B, L, 3] and its mask ->
    (path [B, L, 3], mask [B, L]) tensors."""
    dev = resolve_device(device)
    return _lanes(path, 3, dev), _lanes(mask, 2, dev)


def kino_result_from_numpy(res, device=None) -> KinoResult:
    """The JAX package's KinoResult (fields as numpy arrays, from `plan` or
    from `vmap(plan)`) -> the port's."""
    dev = resolve_device(device)
    path, mask = path_from_numpy(res.path, res.path_mask, dev)
    opt = lambda a, nd: None if a is None else _lanes(a, nd, dev)
    return KinoResult(path=path, path_mask=mask,
                      success=_lanes(res.success, 1, dev),
                      cost=_lanes(res.cost, 1, dev),
                      rounds=_lanes(res.rounds, 1, dev),
                      arena=opt(res.arena, 3),
                      arena_parent=opt(res.arena_parent, 2))


def traj_from_numpy(traj, device=None) -> SE2Traj:
    """The JAX package's SE2Traj (c_xy [Nxy, 6, 2], ts_xy, c_yaw, ts_yaw;
    single or vmapped) -> the port's batched SE2Traj."""
    dev = resolve_device(device)
    return SE2Traj(c_xy=_lanes(traj.c_xy, 4, dev),
                   ts_xy=_lanes(traj.ts_xy, 2, dev),
                   c_yaw=_lanes(traj.c_yaw, 4, dev),
                   ts_yaw=_lanes(traj.ts_yaw, 2, dev))
