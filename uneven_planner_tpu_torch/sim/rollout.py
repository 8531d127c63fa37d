"""Batched closed-loop plant simulator (port of
`uneven_planner_tpu/sim/rollout.py`).

The plant is the kinematic bicycle/unicycle that the reference's Gazebo
wheel mapping realizes (carsim: cmdvel2gazebo.py + true_state_pub.py),
stepped in lockstep with the controller at the 100 Hz control rate
(mpc.cpp:50), with the actuation dead-man semantics
(cmdvel2gazebo.py:80-94) as a command-valid flag.

Every lane is one robot: states [B, 3], commands [B, 2].  The tick loop is a
Python loop over the whole batch; the JAX package's host-side chunking of
that loop was a platform workaround and is not part of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.config import MPCConfig
from uneven_planner_tpu_torch.minco.traj import SE2Traj, expand_traj
from uneven_planner_tpu_torch.mpc import tracker
from uneven_planner_tpu_torch.mpc.tracker import _div
from uneven_planner_tpu_torch.utils.profiling import span


def plant_step(state, cmd, cfg: MPCConfig, dt: float, cmd_valid=True):
    """Integrate the plant for dt under (v, omega-or-steer); the dead-man
    zeroes the velocity when the command is stale.  state [B, 3],
    cmd [B, 2], cmd_valid a bool or [B]."""
    v = cmd[:, 0]
    if cmd_valid is not True:
        v = torch.where(torch.as_tensor(cmd_valid, device=v.device), v,
                        torch.zeros_like(v))
    if cfg.model_type == tracker.DIFF:
        w = cmd[:, 1]
    else:
        w = _div(v, cfg.wheel_base) * torch.tan(cmd[:, 1])
    th = state[:, 2]
    return torch.stack([state[:, 0] + v * torch.cos(th) * dt,
                        state[:, 1] + v * torch.sin(th) * dt,
                        th + w * dt], dim=-1)


class PlantParams(NamedTuple):
    """Non-ideal plant effects.  The reference README names Gazebo wheel
    slip as the main limit of tracking accuracy (README.md:86-89); this
    models the same effects analytically, so that the tracker meets a plant
    that does NOT match its internal kinematic model:

      slip_lon   fraction of commanded longitudinal speed lost to slip
      slip_lat   lateral creep: v_lat = slip_lat * v * omega
      v_tau      first-order actuator lag on v [s]
      steer_tau  first-order lag on steer/omega [s]

    All-zero parameters reduce exactly to the ideal kinematic plant."""
    slip_lon: float = 0.0
    slip_lat: float = 0.0
    v_tau: float = 0.0
    steer_tau: float = 0.0


def plant_step_physical(state, act, cmd, cfg: MPCConfig, dt: float,
                        params: PlantParams, cmd_valid=True):
    """`plant_step` with actuator lag and wheel slip.  `act` [B, 2] is the
    actuator state (v_act, u2_act); returns (new_state, new_act)."""
    v_cmd = cmd[:, 0]
    if cmd_valid is not True:
        v_cmd = torch.where(torch.as_tensor(cmd_valid, device=v_cmd.device),
                            v_cmd, torch.zeros_like(v_cmd))
    a_v = dt / (params.v_tau + dt)
    a_s = dt / (params.steer_tau + dt)
    v_act = act[:, 0] + a_v * (v_cmd - act[:, 0])
    u2_act = act[:, 1] + a_s * (cmd[:, 1] - act[:, 1])

    v_eff = v_act * (1.0 - params.slip_lon)
    if cfg.model_type == tracker.DIFF:
        w = u2_act
    else:
        w = _div(v_eff, cfg.wheel_base) * torch.tan(u2_act)
    v_lat = params.slip_lat * v_eff * w
    c, s = torch.cos(state[:, 2]), torch.sin(state[:, 2])
    new_state = torch.stack([state[:, 0] + (v_eff * c - v_lat * s) * dt,
                             state[:, 1] + (v_eff * s + v_lat * c) * dt,
                             state[:, 2] + w * dt], dim=-1)
    return new_state, torch.stack([v_act, u2_act], dim=-1)


class TrackResult(NamedTuple):
    states: torch.Tensor      # [B, n_steps, 3] plant states
    cmds: torch.Tensor        # [B, n_steps, 2]
    errs: torch.Tensor        # [B, n_steps] tracking error vs ref point 0
    at_goal: torch.Tensor     # [B, n_steps] bool
    mean_err: torch.Tensor    # [B] mean error over pre-goal steps
    # per tick and lane: ADMM iterations over all passes and the most in one
    # pass, relinearization passes, passes that used up the iteration
    # budget, non-finite QP solutions
    qp_iters: Optional[torch.Tensor] = None
    qp_iters_max: Optional[torch.Tensor] = None
    sqp_iters: Optional[torch.Tensor] = None
    qp_capped: Optional[torch.Tensor] = None
    qp_failed: Optional[torch.Tensor] = None


class RollState(NamedTuple):
    state: torch.Tensor    # [B, 3]
    act: torch.Tensor      # [B, 2]
    output: torch.Tensor   # [B, 2, T]
    buff: torch.Tensor     # [B, max(delay, 1), 2]
    t: torch.Tensor        # [B]


def roll_init(start_states, cfg: MPCConfig) -> RollState:
    B = start_states.shape[0]
    new = lambda *shape: start_states.new_zeros((B,) + shape)
    return RollState(state=start_states, act=new(2),
                      output=new(2, cfg.predict_steps),
                      buff=new(max(cfg.delay_num, 1), 2), t=new())


def tick(traj: SE2Traj, s: RollState, cfg: MPCConfig, ctrl_dt: float,
          max_sqp_iter: int, plant_params: Optional[PlantParams]):
    """One control tick of every lane (the episode loop of mpc.cpp:122-192):
    sample the reference horizon, smooth yaw, run the MPC, apply the command
    to the plant.  The error is measured before the yaw smoothing; at the
    goal the command is zeroed but the MPC still runs.  Spans: `up.tick`,
    and under it `up.tick.refs`, `mpc_step`'s and `up.tick.plant`."""
    with span("up.tick"):
        with span("up.tick.refs"):
            refs, at_goal = tracker.get_ref_points(traj, s.t, cfg)
            err = torch.linalg.vector_norm(refs[:, :2, 0] - s.state[:, :2],
                                           dim=-1)
            refs = tracker.smooth_yaw(refs, s.state[:, 2])
        res = tracker.mpc_step(s.state, refs, torch.zeros_like(refs[:, :2]),
                               s.output, s.buff, cfg,
                               max_sqp_iter=max_sqp_iter)
        with span("up.tick.plant"):
            cmd = torch.where(at_goal[:, None], torch.zeros_like(res.cmd),
                              res.cmd)
            if plant_params is None:
                state, act = plant_step(s.state, cmd, cfg, ctrl_dt), s.act
            else:
                state, act = plant_step_physical(s.state, s.act, cmd, cfg,
                                                 ctrl_dt, plant_params)
            nxt = RollState(state=state, act=act, output=res.output,
                            buff=res.output_buff, t=s.t + ctrl_dt)
    return nxt, (s.state, cmd, err, at_goal), res


def track_trajectory_batched(traj: SE2Traj, start_states, cfg: MPCConfig,
                             n_steps: int, ctrl_dt: float = 0.01,
                             max_sqp_iter: int = 3,
                             plant_params: Optional[PlantParams] = None,
                             traj_batched: bool = False,
                             device=None) -> TrackResult:
    """Closed-loop tracking of B lanes for n_steps control ticks, the whole
    batch in one loop.  start_states [B, 3]; `traj_batched` selects per-lane
    trajectories ([B, ...] SE2Traj leaves, the pipeline case) over one
    shared trajectory (a batch of one, the figure-eight case).
    `plant_params` switches the plant to the slip/lag model.  Runs on the
    card unless `device` names another; the trajectory must lie there."""
    dev = resolve_device(device)
    if traj.c_xy.device.type != dev.type:
        raise ValueError(f"the trajectory lies on {traj.c_xy.device}, the "
                         f"tracking was asked for on {dev}")
    dtype = traj.c_xy.dtype
    start_states = torch.as_tensor(start_states, dtype=dtype).to(dev)
    B = start_states.shape[0]
    if not traj_batched:
        traj = expand_traj(traj, B)
    elif traj.c_xy.shape[0] != B:
        raise ValueError(f"{traj.c_xy.shape[0]} trajectories for {B} lanes")

    s = roll_init(start_states, cfg)
    outs, diag = [], []
    for _ in range(n_steps):
        s, out, res = tick(traj, s, cfg, ctrl_dt, max_sqp_iter, plant_params)
        outs.append(out)
        diag.append((res.qp_iters, res.qp_iters_max, res.sqp_iters,
                     res.qp_capped, res.qp_failed))
    states, cmds, errs, at_goal = (torch.stack(col, dim=1)
                                   for col in zip(*outs))
    pre_goal = ~at_goal
    mean_err = (errs * pre_goal).sum(1) / pre_goal.sum(1).clamp(min=1)
    return TrackResult(states, cmds, errs, at_goal, mean_err,
                       *(torch.stack(col, dim=1) for col in zip(*diag)))


def track_trajectory(traj: SE2Traj, start_state, cfg: MPCConfig,
                     n_steps: int, ctrl_dt: float = 0.01,
                     max_sqp_iter: int = 3,
                     plant_params: Optional[PlantParams] = None,
                     device=None) -> TrackResult:
    """Closed-loop tracking of one trajectory from start_state [3]:
    `track_trajectory_batched` on a batch of one, with the lane dimension
    kept (every field is [1, ...])."""
    return track_trajectory_batched(
        traj, torch.as_tensor(start_state)[None], cfg, n_steps, ctrl_dt,
        max_sqp_iter, plant_params, traj_batched=True, device=device)
