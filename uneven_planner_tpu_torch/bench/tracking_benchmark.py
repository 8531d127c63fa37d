"""Tracking-error benchmark harness, the reference's bk_mode (port of
`uneven_planner_tpu/bench/tracking_benchmark.py`).

The reference benchmark loop (mpc.cpp:59-93, 139-177, and the TrajAnalyzer
loaders traj_anal.hpp:183-354): load a file of trajectories in one of three
formats, run one tracking episode a trajectory (teleport to its initial
pose, track to the goal, record the mean ||xy error||), and write the
per-episode errors and `all_mean_track_err` to an `err_*` file.

File formats (whitespace-separated, one trajectory a line):
- "proposed" (BK_UNEVEN, traj_anal.hpp:185-259): MINCO waypoints --
  n_pos n_ang, start xy, inner xys, tail xy, start yaw, inner yaws,
  tail yaw, pos piece times, yaw piece times; rebuilt by a MINCO solve.
- "Wangs" (BK_TOWARDS, :260-313): piece count, then per piece its
  duration and a 3 x 6 descending-power coefficient matrix; the heading
  follows the velocity.
- "Jians" (BK_PUTN, :314-353): waypoint count, dt, then x y theta triples.

Episodes run one at a time through the tracking MPC and the kinematic
plant on a batch of one lane, as the JAX package runs them; on the card
every tick goes through the gather kernels (piece rows, piece location) and
the ADMM kernel.  Teleporting is resetting the plant's state.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.config import MPCConfig
from uneven_planner_tpu_torch.minco import minco
from uneven_planner_tpu_torch.minco.traj import SE2Traj
from uneven_planner_tpu_torch.mpc import tracker
from uneven_planner_tpu_torch.sim import rollout


class PolyTraj3(NamedTuple):
    """Wangs format: 3-D quintic pieces, descending coefficients."""
    coeffs: torch.Tensor  # [N, 3, 6] (t^5 .. 1)
    ts: torch.Tensor      # [N]


class WaypointTraj(NamedTuple):
    """Jians format: (x, y, theta) waypoints at a fixed dt."""
    points: torch.Tensor  # [M, 3]
    dt: float


def _proposed(d, to) -> SE2Traj:
    """One "proposed" line -> an SE2Traj batch of one (a MINCO solve for xy
    and one for yaw, zero boundary velocity and acceleration)."""
    npos, nang = int(d[0]), int(d[1])
    v = [float(a) for a in d[2:]]
    i = 0

    def take(n):
        nonlocal i
        out = v[i:i + n]
        i += n
        return out
    start_xy = take(2)
    inner_xy = np.asarray(take(2 * (npos - 1))).reshape(npos - 1, 2)
    tail_xy = take(2)
    start_yaw = take(1)
    inner_yaw = np.asarray(take(nang - 1)).reshape(nang - 1, 1)
    tail_yaw = take(1)
    pos_t, ang_t = np.asarray(take(npos)), np.asarray(take(nang))
    pva = lambda p: np.concatenate([[p], np.zeros((2, len(p)))])
    c_xy = minco.generate(to(inner_xy)[None], to(pos_t)[None],
                          to(pva(start_xy))[None], to(pva(tail_xy))[None])
    c_yaw = minco.generate(to(inner_yaw)[None], to(ang_t)[None],
                           to(pva(start_yaw))[None], to(pva(tail_yaw))[None])
    return SE2Traj(c_xy, to(pos_t)[None], c_yaw, to(ang_t)[None])


def load_benchmark_file(path: str, dtype=torch.float32, device=None):
    """(kind, [trajectories]) on `device` (None: CUDA) in `dtype`; the kind
    comes from the file name as in the reference (find "proposed" /
    "Wangs" / "Jians")."""
    dev = resolve_device(device)
    to = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if "proposed" in path:
        return "proposed", [_proposed(d, to) for d in lines]
    if "Wangs" in path:
        trajs = []
        for d in lines:
            n = int(d[0])
            rows = np.asarray([float(a) for a in d[1:1 + 19 * n]]
                              ).reshape(n, 19)
            trajs.append(PolyTraj3(coeffs=to(rows[:, 1:].reshape(n, 3, 6)),
                                   ts=to(rows[:, 0])))
        return "Wangs", trajs
    if "Jians" in path:
        trajs = []
        for d in lines:
            m = int(d[0])
            pts = np.asarray([float(a) for a in d[2:2 + 3 * m]]
                             ).reshape(m, 3)
            trajs.append(WaypointTraj(points=to(pts), dt=float(d[1])))
        return "Jians", trajs
    raise ValueError(f"unknown benchmark format for {path}")


def _poly3_state(traj: PolyTraj3, t):
    """(position, velocity), each [..., 3], of a descending-coefficient 3-D
    polynomial trajectory at times t [...]."""
    t = torch.as_tensor(t, dtype=traj.ts.dtype, device=traj.ts.device)
    flat = t.reshape(1, -1)
    idx, s = minco.locate_piece(torch.cumsum(traj.ts, 0)[None], flat)
    c = traj.coeffs[idx[0]]                              # [K, 3, 6]
    s = s[0][:, None]
    k = torch.arange(5, -1, -1, dtype=t.dtype, device=t.device)
    powers = s ** k
    dpow = torch.cat([k[:-1] * s ** (k[:-1] - 1),
                      torch.zeros_like(s)], dim=-1)
    pos = torch.einsum("kdp,kp->kd", c, powers)
    vel = torch.einsum("kdp,kp->kd", c, dpow)
    return pos.reshape(t.shape + (3,)), vel.reshape(t.shape + (3,))


def ref_points_for(kind: str, traj, t_now, cfg: MPCConfig):
    """Reference horizon [B, 3, T] and at-goal flags [B] at times t_now [B]
    for any benchmark trajectory (getRefPoints, traj_anal.hpp:485-573); a
    "proposed" trajectory is an SE2Traj of B lanes, the others one
    trajectory shared by the B lanes."""
    if kind == "proposed":
        return tracker.get_ref_points(traj, t_now, cfg)
    T = cfg.predict_steps
    ts = t_now[:, None] + torch.arange(T, dtype=t_now.dtype,
                                       device=t_now.device) * cfg.dt
    if kind == "Wangs":
        dur = traj.ts.sum()
        pos, vel = _poly3_state(traj, torch.minimum(ts, dur))
        theta = torch.atan2(vel[..., 1], vel[..., 0])
        refs = torch.stack([pos[..., 0], pos[..., 1], theta], dim=1)
        return refs, t_now > dur + 1.0
    if kind == "Jians":
        m = traj.points.shape[0]
        dur = traj.dt * m
        idx = (torch.clamp(ts, max=dur - 1e-9) / ts.new_full((), traj.dt)
               ).to(torch.int32).clamp(0, m - 1)
        refs = traj.points[idx.long()].permute(0, 2, 1)
        return refs, t_now > dur + 1.0
    raise ValueError(kind)


class EpisodeResult(NamedTuple):
    mean_err: float
    steps: int


def _proposed_start(traj: SE2Traj):
    zero = traj.ts_xy.new_zeros(())
    p0 = minco.eval_piece(traj.c_xy[0, 0], zero)[0]
    y0 = minco.eval_piece(traj.c_yaw[0, 0], zero)[0]
    return torch.cat([p0, y0])


def run_benchmark(path: str, cfg: MPCConfig, out_path: str | None = None,
                  ctrl_dt: float = 0.01, max_sqp_iter: int = 1,
                  max_steps: int = 6000, dtype=torch.float32,
                  device=None) -> Tuple[List[EpisodeResult], float]:
    """The episode loop (mpc.cpp:139-177): teleport, track, log the
    errors; on `device` (None: CUDA) in `dtype`.  Returns the episodes'
    (mean error, ticks) and their sum, and writes them to `out_path` in
    the reference's err-file format."""
    dev = resolve_device(device)
    kind, trajs = load_benchmark_file(path, dtype, dev)
    results = []
    for traj in trajs:
        if kind == "proposed":
            dur = float(traj.total_duration[0])
            n_steps = min(int((dur + 1.2) / ctrl_dt), max_steps)
            res = rollout.track_trajectory(
                traj, _proposed_start(traj), cfg, n_steps, ctrl_dt=ctrl_dt,
                max_sqp_iter=max_sqp_iter, device=dev)
            ep = EpisodeResult(float(res.mean_err[0]), res.errs.shape[1])
        else:
            ep = EpisodeResult(*_track_generic(kind, traj, cfg, ctrl_dt,
                                               max_sqp_iter, max_steps))
        results.append(ep)
    total = float(sum(r.mean_err for r in results))
    if out_path:
        with open(out_path, "w") as f:
            for r in results:
                f.write(f"{r.mean_err}\n")
            f.write(f"all_mean_track_err: {total}\n")
    return results, total


def _track_generic(kind, traj, cfg, ctrl_dt, max_sqp_iter, max_steps):
    """Closed-loop tracking of a non-MINCO trajectory on one lane: the MPC
    and the kinematic plant, tick by tick."""
    if kind == "Wangs":
        dur = float(traj.ts.sum())
        pos0, vel0 = _poly3_state(traj, traj.ts.new_zeros(()))
        start = torch.stack([pos0[0], pos0[1],
                             torch.atan2(vel0[1], vel0[0])])
    else:
        start = traj.points[0]
        dur = traj.dt * traj.points.shape[0]
    n_steps = min(int((dur + 1.2) / ctrl_dt), max_steps)
    s = rollout.roll_init(start[None], cfg)
    errs, at_goal = [], []
    for _ in range(n_steps):
        refs, goal = ref_points_for(kind, traj, s.t, cfg)
        errs.append(torch.linalg.vector_norm(refs[:, :2, 0]
                                             - s.state[:, :2], dim=-1))
        at_goal.append(goal)
        refs = tracker.smooth_yaw(refs, s.state[:, 2])
        res = tracker.mpc_step(s.state, refs, torch.zeros_like(refs[:, :2]),
                               s.output, s.buff, cfg,
                               max_sqp_iter=max_sqp_iter)
        cmd = torch.where(goal[:, None], torch.zeros_like(res.cmd), res.cmd)
        s = rollout.RollState(
            state=rollout.plant_step(s.state, cmd, cfg, ctrl_dt), act=s.act,
            output=res.output, buff=res.output_buff, t=s.t + ctrl_dt)
    errs = torch.cat(errs).cpu().numpy()
    pre = ~torch.cat(at_goal).cpu().numpy()
    mean_err = float(errs[pre].mean()) if pre.any() else float(errs.mean())
    return mean_err, n_steps


def save_proposed_file(path: str, trajs: List[SE2Traj]) -> None:
    """Write trajectories (each an SE2Traj batch of one) in the reference's
    "proposed" format, so that the reference and this package can exchange
    benchmark files."""
    with open(path, "w") as f:
        for tr in trajs:
            c_xy, ts_xy = tr.c_xy[0].cpu().double(), tr.ts_xy[0].cpu().double()
            c_yaw = tr.c_yaw[0].cpu().double()
            ts_yaw = tr.ts_yaw[0].cpu().double()
            npos, nang = ts_xy.shape[0], ts_yaw.shape[0]
            zero = ts_xy.new_zeros(())
            at = lambda c, s: minco.eval_piece(c, s)[0].numpy()
            starts = [at(c_xy[i], zero) for i in range(npos)]
            ystarts = [float(at(c_yaw[i], zero)[0]) for i in range(nang)]
            row = [npos, nang]
            for s in starts:
                row += list(s)
            row += list(at(c_xy[-1], ts_xy[-1]))
            row += ystarts + [float(at(c_yaw[-1], ts_yaw[-1])[0])]
            row += list(ts_xy.numpy()) + list(ts_yaw.numpy())
            f.write(" ".join(str(x) if isinstance(x, int) else
                             str(float(x)) for x in row) + "\n")
