"""Carry state across from the JAX package: its arrays come in as numpy
arrays (`np.asarray(jax_array)`), port tensors come out.

For this system the "weights" are the terrain field with its gather tables
and the solver state (boundaries, duals, scalings, the nested solve's
`SolveState`, an L-BFGS result).  The JAX package keeps the tables
channel-major ([8, Ncells] f32 pair table, [6, 2*Ncells] f32 words of the
f16 table, [12, Ncells] f32 words of the split-bf16 table); the port keeps
them row-major (32-byte rows, 48-byte rows for the split-bf16 table), so
conversion is a transpose (and an 8-word pad for the f16 table) with the
bits unchanged.  Front-end paths, search results, trajectories, wire
messages, QP data and solutions, the rollout carry and the tracking and
pipeline results keep their layout; the port's carry a leading scenario
dimension, which a single (un-vmapped) JAX result gets here.
"""

from __future__ import annotations

import numpy as np
import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.frontend.kino_init import KinoResult
from uneven_planner_tpu_torch.minco.traj import SE2Traj
from uneven_planner_tpu_torch.mpc.traj_msg import SE2TrajMsg
from uneven_planner_tpu_torch.parallel.pipeline import PipelineResult
from uneven_planner_tpu_torch.sim.rollout import RollState, TrackResult
from uneven_planner_tpu_torch.solver.admm_qp import QPSolution
from uneven_planner_tpu_torch.solver.alm import (Boundary, DualState,
                                                 Scaling, SolveState)
from uneven_planner_tpu_torch.solver.lbfgs import LBFGSResult
from uneven_planner_tpu_torch.terrain import grid as tgrid


def _t(a, device):
    return torch.tensor(np.asarray(a), device=device)


def grid_from_numpy(data, *, xy_resolution: float, yaw_resolution: float,
                    origin, occ, occ_xy=None, gravity: float = 9.81,
                    data_pair=None, data_packed16=None, data_packed=None,
                    device=None) -> tgrid.TerrainGrid:
    """TerrainGrid from a numpy RXS2 field [Nx, Ny, Nyaw, 4], its geometry
    and occupancy, with the pair and f16 gather tables.

    `data_pair` ([8, Ncells]) and `data_packed16` ([6, 2*Ncells], f32 or
    uint32 words) in the JAX package's layout are converted (transposed,
    and their cells reordered with x fastest) when given; a table not given
    is built in the port.  The split-bf16 table `data_packed` ([12,
    Ncells] words) is attached only when given."""
    dev = resolve_device(device)
    occ = np.asarray(occ)
    occ_xy = occ.any(axis=-1) if occ_xy is None else np.asarray(occ_xy)
    grid = tgrid.TerrainGrid(
        data=_t(data, dev), occ=_t(occ, dev), occ_xy=_t(occ_xy, dev),
        xy_resolution=float(xy_resolution),
        yaw_resolution=float(yaw_resolution),
        origin=tuple(float(o) for o in origin), gravity=float(gravity))
    if data_pair is not None:
        grid = grid.replace(data_pair=_t(tgrid.x_fastest(
            np.asarray(data_pair).T, grid.voxel_num), dev))
    else:
        grid = tgrid.with_pair_table(grid)
    if data_packed16 is not None:
        words = np.ascontiguousarray(np.asarray(data_packed16)) \
            .view(np.int32).T                            # [2*Ncells, 6]
        packed = np.zeros((words.shape[0], 8), np.int32)
        packed[:, :6] = words
        grid = grid.replace(data_packed16=_t(
            tgrid.x_fastest(packed, grid.voxel_num), dev))
    else:
        grid = tgrid.with_packed_f16(grid)
    if data_packed is not None:
        words = np.ascontiguousarray(np.asarray(data_packed)) \
            .view(np.int32).T                            # [Ncells, 12]
        grid = grid.replace(data_packed=_t(
            tgrid.x_fastest(words, grid.voxel_num), dev))
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


def solve_state_from_numpy(state, device=None) -> SolveState:
    """The JAX package's SolveState of `vmap(init_state)` or of a
    vmapped `outer_round` (numpy fields, duals a DualState) -> the port's,
    with its int32 counters as int64."""
    dev = resolve_device(device)
    d = state.duals
    count = lambda a: _t(a, dev).long()
    return SolveState(
        x=_t(state.x, dev), duals=duals_from_numpy(d.lam, d.mu, d.rho, dev),
        it=count(state.it), done=_t(state.done, dev),
        inner_iters=count(state.inner_iters), res_h=_t(state.res_h, dev),
        res_g=_t(state.res_g, dev), lbfgs_status=count(state.lbfgs_status))


def lbfgs_result_from_numpy(res, device=None) -> LBFGSResult:
    """The JAX package's LBFGSResult (vmapped; numpy fields) -> the
    port's, with its int32 counters as int64."""
    dev = resolve_device(device)
    return LBFGSResult(*[_t(getattr(res, f), dev).long()
                         if f in ("status", "iters", "evals")
                         else _t(getattr(res, f), dev)
                         for f in LBFGSResult._fields[:6]])


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


def _fields(cls, obj, ndims, device):
    """`cls` from the same-named fields of `obj`, each given its lane
    dimension; fields `obj` lacks (or holds as None) stay None."""
    get = lambda f: getattr(obj, f, None)
    return cls(**{f: None if get(f) is None else _lanes(get(f), nd, device)
                  for f, nd in ndims.items()})


def traj_msg_from_numpy(msg, device=None) -> SE2TrajMsg:
    """The JAX package's SE2TrajMsg (single or vmapped) -> the port's."""
    dev = resolve_device(device)
    return _fields(SE2TrajMsg, msg, dict(
        pos_pts=3, pos_ts=2, angle_pts=3, angle_ts=2, init_v=2, init_a=2),
        dev)


def qp_from_numpy(P, q, A, l, u, device=None):
    """QP data (P [n, n], q [n], A [m, n], l, u [m]; single or with a
    leading lane dimension) -> the port's batched (P, q, A, l, u)."""
    dev = resolve_device(device)
    return tuple(_lanes(a, nd, dev)
                 for a, nd in ((P, 3), (q, 2), (A, 3), (l, 2), (u, 2)))


def qp_solution_from_numpy(sol, device=None) -> QPSolution:
    dev = resolve_device(device)
    return _fields(QPSolution, sol, dict(
        x=2, y=2, iters=1, r_prim=1, r_dual=1, converged=1), dev)


def roll_state_from_numpy(carry, device=None) -> RollState:
    """The rollout carry (state, act, output, buff, t) of the JAX package's
    tracking loop -> the port's."""
    dev = resolve_device(device)
    return _fields(RollState, carry, dict(
        state=2, act=2, output=3, buff=3, t=1), dev)


def track_result_from_numpy(res, device=None) -> TrackResult:
    dev = resolve_device(device)
    return _fields(TrackResult, res, dict(
        states=3, cmds=3, errs=2, at_goal=2, mean_err=1, qp_iters=2,
        qp_iters_max=2, sqp_iters=2, qp_capped=2, qp_failed=2), dev)


def pipeline_result_from_numpy(res, device=None) -> PipelineResult:
    dev = resolve_device(device)
    out = _fields(PipelineResult, res, dict(
        plan_success=1, alm_converged=1, outer_iters=1, inner_iters=1,
        non_hol=1, mean_track_err=1, final_track_err=1, res_h=1, res_g=1),
        dev)
    traj = getattr(res, "traj", None)
    return out._replace(
        traj=None if traj is None else traj_from_numpy(traj, dev))
