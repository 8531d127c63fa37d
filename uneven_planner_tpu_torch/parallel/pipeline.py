"""Plan -> optimize -> track pipeline (port of
`uneven_planner_tpu/parallel/pipeline.py`).

The end-to-end product: front-end batched search, MINCO PHR-ALM
optimization, wire-format round trip, and closed-loop MPC tracking in the
batched simulator, for a batch of scenarios at once.  It replaces the
reference's ROS node graph (goal callback -> plan_manager -> traj topic ->
mpc node -> cmd topic -> Gazebo) with one function.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uneven_planner_tpu_torch import manager, resolve_device
from uneven_planner_tpu_torch.config import SceneConfig
from uneven_planner_tpu_torch.frontend import kino_init
from uneven_planner_tpu_torch.minco.traj import SE2Traj, non_hol_error
from uneven_planner_tpu_torch.mpc import traj_msg
from uneven_planner_tpu_torch.sim import rollout
from uneven_planner_tpu_torch.solver import alm


class PipelineResult(NamedTuple):
    plan_success: torch.Tensor     # [B] bool
    alm_converged: torch.Tensor    # [B] bool
    outer_iters: torch.Tensor
    inner_iters: torch.Tensor
    non_hol: torch.Tensor
    mean_track_err: torch.Tensor
    final_track_err: torch.Tensor
    # final scaled ALM residuals of the solve whose trajectory was tracked
    res_h: Optional[torch.Tensor] = None
    res_g: Optional[torch.Tensor] = None
    # the tracked trajectories (after the wire round trip)
    traj: Optional[SE2Traj] = None
    # the closed-loop record (states, commands, QP diagnostics per tick)
    track: Optional[rollout.TrackResult] = None


def plan_track_batch(grid, scfg: SceneConfig, starts, goals,
                     shape: alm.ProblemShape, n_track_steps: int = 500,
                     lbfgs_overrides: Optional[dict] = None,
                     max_sqp_iter: int = 3, metric_samples: int = 1024,
                     plant_params=None, device=None) -> PipelineResult:
    """B full scenarios, starts and goals [B, 3]: search -> optimize ->
    message round trip -> closed-loop tracking, lane for lane what the JAX
    package's `vmap(plan_track_scenario)` returns.

    `max_sqp_iter` bounds the MPC relinearization loop (the reference
    relinearizes until du < du_th or a 10 ms wall budget, mpc.cpp:797-841).
    `plant_params` switches the tracking plant to the slip/actuator-lag
    model (`sim.rollout.PlantParams`)."""
    dev = resolve_device(device)
    if grid.device.type != dev.type:
        raise ValueError(f"the grid lies on {grid.device}, the pipeline was "
                         f"asked for on {dev}")
    dtype = grid.data.dtype
    starts = torch.as_tensor(starts, dtype=dtype).to(dev)
    goals = torch.as_tensor(goals, dtype=dtype).to(dev)

    kres = kino_init.plan(grid, scfg.frontend, starts, goals)
    x0, bound = manager.init_guess_fixed_device(
        kres.path, kres.path_mask, scfg.manager, shape.piece_xy,
        shape.piece_yaw)
    ares = alm.solve_flat(x0, bound, shape, grid, scfg.alm,
                          lbfgs_overrides=lbfgs_overrides)

    # wire-format round trip: the tracker reconstructs the polynomial from
    # waypoints + times exactly as the reference controller does
    traj = traj_msg.traj_from_msg(traj_msg.msg_from_traj(ares.traj))
    tres = rollout.track_trajectory_batched(
        traj, starts, scfg.mpc, n_track_steps, max_sqp_iter=max_sqp_iter,
        plant_params=plant_params, traj_batched=True, device=dev)
    nh = non_hol_error(ares.traj, num_samples=metric_samples)
    return PipelineResult(
        plan_success=kres.success, alm_converged=ares.converged,
        outer_iters=ares.outer_iters, inner_iters=ares.inner_iters,
        non_hol=nh, mean_track_err=tres.mean_err,
        final_track_err=tres.errs[:, -1], res_h=ares.res_h, res_g=ares.res_g,
        traj=traj, track=tres)


def plan_track_scenario(grid, scfg: SceneConfig, start, goal,
                        shape: alm.ProblemShape, **kwargs) -> PipelineResult:
    """One full scenario: `plan_track_batch` on a batch of one, with the
    scenario dimension kept (every field is [1, ...])."""
    one = lambda a: torch.as_tensor(a)[None]
    return plan_track_batch(grid, scfg, one(start), one(goal), shape,
                            **kwargs)
