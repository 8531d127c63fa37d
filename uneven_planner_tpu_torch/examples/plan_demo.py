"""End-to-end planning demo on the port (port of `examples/plan_demo.py`):
the textual equivalent of the reference's "click a goal in RViz" flow
(hill.sh -> plan_manager -> back-end report).

Builds (or loads) a terrain map, searches an init path, solves the
reference's nested ALM on it, prints the post-solve report the reference
prints after every solve (plan_manager.cpp:142-148), optionally tracks the
trajectory in closed loop, and writes the planned SE(3) poses to a CSV.

    python -m uneven_planner_tpu_torch.examples.plan_demo [--scene hill]
        [--start -3 -3 0] [--goal 0 -3 0] [--out traj.csv] [--track]
        [--cache-dir data] [--device cpu]

It runs on the card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from uneven_planner_tpu_torch import manager, resolve_device
from uneven_planner_tpu_torch.config import MapConfig, scene_config
from uneven_planner_tpu_torch.frontend import kino_init
from uneven_planner_tpu_torch.minco.traj import (max_metrics, non_hol_error,
                                                 sample_dense)
from uneven_planner_tpu_torch.mpc import traj_msg
from uneven_planner_tpu_torch.sim import rollout
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain import build, io
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

SHAPE = alm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
LBFGS_OVERRIDES = {"mem_size": 8, "max_iterations": 250}
TRACK_STEPS = 600
METRIC_SAMPLES = 2048


class DemoResult(NamedTuple):
    kres: kino_init.KinoResult      # the search, a batch of one
    res: Optional[alm.ALMResult]    # None when the search failed
    report: dict                    # the post-solve report's seven values
    lines: list                     # the report's printed lines
    track: Optional[rollout.TrackResult]
    poses: Optional[np.ndarray]     # [n, 4] x, y, z, yaw written to `out`


def load_map(scene: str, map_cfg: MapConfig, cache_dir: str, device,
             dtype=np.float32, log=print) -> tgrid.TerrainGrid:
    """The scene's grid on `device`: the synthetic hill, the npz cache
    `cache_dir/<scene>.npz`, or a fresh `construct_map` of the scene's
    cloud, then cached (the reference's .map-cache behaviour)."""
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"{scene}.npz")
    t0 = time.perf_counter()
    if scene == "hill":
        grid = make_synthetic_grid(map_cfg, dtype=dtype, device=device)
        log(f"[map] synthetic hill grid in {time.perf_counter()-t0:.1f}s")
    elif os.path.exists(cache):
        data = torch.from_numpy(np.asarray(io.load_map_npz(cache), dtype))
        grid = tgrid.from_buffers(
            data.to(device), map_cfg.min_cnormal, map_cfg.max_rho,
            map_cfg.xy_resolution, map_cfg.yaw_resolution,
            map_cfg.map_origin, map_cfg.gravity)
        log(f"[map] loaded cache {cache} in {time.perf_counter()-t0:.1f}s")
    else:
        cloud = io.load_scene_cloud(scene)
        log(f"[map] cloud: {len(cloud)} pts; constructing "
            f"{map_cfg.voxel_num} grid...")
        grid = build.construct_map(cloud, map_cfg, device=device,
                                   dtype=getattr(torch, np.dtype(dtype).name))
        io.save_map_npz(cache, grid.data.cpu().numpy())
        log(f"[map] constructed + cached in {time.perf_counter()-t0:.1f}s")
    return grid


def report_lines(report: dict, alm_cfg) -> list:
    """The reference's post-solve report (plan_manager.cpp:142-148)."""
    a = alm_cfg
    return [f"equal error: {report['non_hol']:.6f}",
            f"max vx rate: {report['max_vx']:.4f} (limit {a.max_vel})",
            f"max ax rate: {report['max_ax']:.4f} (limit {a.max_acc_lon})",
            f"max ay rate: {report['max_ay']:.4f} (limit {a.max_acc_lat})",
            f"max cur:     {report['max_cur']:.4f} (limit {a.max_kap})",
            f"min cosxi:   {report['min_cxi']:.4f} (limit {a.min_cxi})",
            f"max sigma:   {report['max_sig']:.5f} (limit {a.max_sig})"]


def run(map_cfg: MapConfig | None = None, scene: str = "hill",
        start=(-3.0, -3.0, 0.0), goal=(0.0, -3.0, 0.0),
        out: str | None = None, track: bool = False,
        cache_dir: str = "data", device=None, dtype=np.float32,
        log=print) -> DemoResult:
    """The demo on `device` (None: the card) over `map_cfg` (None: the
    scene's): map, search, on-device init guess, nested `alm.solve`, the
    post-solve report, with `track` closed-loop tracking of the wire
    round trip, with `out` the SE(3) poses as CSV.  The grid carries the
    pair table (the solve's exact lookups) and the f16 table (the search's
    sigma)."""
    dev = resolve_device(device)
    scfg = scene_config(scene)
    map_cfg = map_cfg or scfg.map
    grid = load_map(scene, map_cfg, cache_dir, dev, dtype, log)
    grid = tgrid.with_packed_f16(tgrid.with_pair_table(grid))
    tdtype = grid.data.dtype
    one = lambda p: torch.tensor([p], dtype=tdtype, device=dev)
    start_t, goal_t = one(start), one(goal)

    # ---- front end
    t0 = time.perf_counter()
    kres = kino_init.plan(grid, scfg.frontend, start_t, goal_t)
    success = bool(kres.success[0])
    log(f"[front end] success={success} rounds={int(kres.rounds[0])} "
        f"cost={float(kres.cost[0]):.3f} ({time.perf_counter()-t0:.1f}s)")
    if not success:
        return DemoResult(kres, None, {}, [], None, None)

    # ---- back end
    x0, bound = manager.init_guess_fixed_device(
        kres.path, kres.path_mask, scfg.manager, SHAPE.piece_xy,
        SHAPE.piece_yaw)
    t0 = time.perf_counter()
    res = alm.solve(x0, bound, SHAPE, grid, scfg.alm,
                    lbfgs_overrides=LBFGS_OVERRIDES)
    log(f"[back end] converged={bool(res.converged[0])} "
        f"outer={int(res.outer_iters[0])} inner={int(res.inner_iters[0])} "
        f"({time.perf_counter()-t0:.1f}s)")

    # ---- post-solve report (plan_manager.cpp:142-148)
    report = {k: float(v[0]) for k, v in
              max_metrics(res.traj, grid, METRIC_SAMPLES).items()}
    report["non_hol"] = float(non_hol_error(res.traj, METRIC_SAMPLES)[0])
    lines = report_lines(report, scfg.alm)
    for ln in lines:
        log(ln)

    # ---- tracking (optional)
    tres = None
    if track:
        traj = traj_msg.traj_from_msg(traj_msg.msg_from_traj(res.traj))
        t0 = time.perf_counter()
        tres = rollout.track_trajectory(traj, start_t[0], scfg.mpc,
                                        n_steps=TRACK_STEPS,
                                        max_sqp_iter=1, device=dev)
        log(f"[tracking] mean err={float(tres.mean_err[0])*100:.2f} cm "
            f"({time.perf_counter()-t0:.1f}s)")

    # ---- export SE(3) path
    rows = None
    if out:
        poses, mask = sample_dense(res.traj, 1024, 0.03)
        poses = poses[0][mask[0]]
        _, p3 = tgrid.se3_lift(grid, poses)
        rows = torch.cat([p3, poses[:, 2:3]], dim=1).cpu().numpy()
        np.savetxt(out, rows, delimiter=",", header="x,y,z,yaw",
                   comments="")
        log(f"[export] {len(rows)} SE(3) poses -> {out}")
    return DemoResult(kres, res, report, lines, tres, rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="hill")
    ap.add_argument("--start", nargs=3, type=float, default=[-3.0, -3.0, 0.0])
    ap.add_argument("--goal", nargs=3, type=float, default=[0.0, -3.0, 0.0])
    ap.add_argument("--out", default=None, help="CSV of planned SE(3) poses")
    ap.add_argument("--track", action="store_true",
                    help="also run closed-loop MPC tracking")
    ap.add_argument("--cache-dir", default="data")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    r = run(scene=args.scene, start=args.start, goal=args.goal,
            out=args.out, track=args.track, cache_dir=args.cache_dir,
            device=args.device)
    return 0 if r.res is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
