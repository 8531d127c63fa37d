"""Per-scene evaluation of the whole plan -> optimize -> track pipeline
(port of `uneven_planner_tpu/bench/scene_eval.py`).

For a scene (the synthetic hill, or a point-cloud scene whose
`maps/<name>.pcd` is present: `api.load_or_build_scene`) it samples
free-space start/goal scenarios, runs `parallel.pipeline.plan_track_batch`
on them, retries the failed lanes once with easier settings, and reports:

  - the map's build time and plane fits/s when it was built fresh,
  - the front end's success share,
  - the ALM's converged and accepted shares, and the reference's 6-metric
    post-solve report (max |vx|, |ax|, |ay|, |kappa|, min cos_xi, max sigma;
    ALMTrajOpt::getMaxVxAxAyCurAttSig, alm_traj_opt.h:170-229) over the
    converged lanes,
  - the closed-loop mean and final tracking error,
  - which scenarios the C++ A* oracle (`utils/native.kino_astar_plan`, the
    reference's kino_astar.cpp:67-236 on the host over the same grid and
    front-end settings) finds feasible, and the front end's and the
    pipeline's success shares on those.

    python -m uneven_planner_tpu_torch.bench.scene_eval [--scenes hill]
        [--batch 64] [--out SCENES.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from uneven_planner_tpu_torch import api, resolve_device
from uneven_planner_tpu_torch.minco.traj import SE2Traj, max_metrics
from uneven_planner_tpu_torch.parallel import pipeline
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.utils import native


def sample_free_scenarios(occ_xy: np.ndarray, map_cfg, B: int, rng,
                          d_min: float = 1.5, d_max: float = 3.0,
                          margin_cells: int = 2,
                          border_margin: float = 0.8):
    """Rejection-sample B (start, goal) SE(2) pairs whose ends are free in
    the 2-D occupancy (the reference aborts on an occupied start or goal,
    kino_astar.cpp:86-95), in one free component (4-connected), away from
    the map border by `border_margin` and from obstacles by `margin_cells`
    (relaxed when too little free space is left); the yaw faces the goal
    (plan_manager.cpp:86-94).  The same draws as the JAX sampler, so one
    seed gives both packages the same scenarios."""
    from scipy import ndimage
    nx, ny = occ_xy.shape
    res = map_cfg.xy_resolution
    ox, oy, _ = map_cfg.map_origin
    lo = np.array([ox + border_margin, oy + border_margin])
    hi = np.array([ox + nx * res - border_margin,
                   oy + ny * res - border_margin])
    free = ~occ_xy
    for m in range(margin_cells, -1, -1):
        er = free.copy()
        for _ in range(m):
            f = er.copy()
            f[1:, :] &= er[:-1, :]
            f[:-1, :] &= er[1:, :]
            f[:, 1:] &= er[:, :-1]
            f[:, :-1] &= er[:, 1:]
            er = f
        if er.sum() >= max(64, 4 * B):
            break
    free = er
    labels, _ = ndimage.label(free)
    ii, jj = np.nonzero(free)
    if ii.size < 2:
        raise RuntimeError("no free space to sample scenarios from")
    pts = np.stack([ox + (ii + 0.5) * res, oy + (jj + 0.5) * res], axis=1)
    comp = labels[ii, jj]
    inner = ((pts > lo) & (pts < hi)).all(axis=1)
    if inner.sum() >= 2:
        pts, comp = pts[inner], comp[inner]
    starts, goals = [], []
    attempts = 0
    while len(starts) < B:
        attempts += 1
        if attempts > 200000:
            raise RuntimeError(
                f"scenario sampling stalled at {len(starts)}/{B}")
        if attempts % 20000 == 0:
            d_min = max(0.5, 0.8 * d_min)
        k = rng.integers(len(pts))
        a = pts[k]
        ang = rng.uniform(-np.pi, np.pi)
        d = rng.uniform(d_min, d_max)
        g = a + d * np.array([np.cos(ang), np.sin(ang)])
        gi, gj = int((g[0] - ox) / res), int((g[1] - oy) / res)
        if not (0 <= gi < nx and 0 <= gj < ny) or not free[gi, gj]:
            continue
        if labels[gi, gj] != comp[k]:
            continue
        if (g < lo).any() or (g > hi).any():
            continue
        yaw = np.arctan2(g[1] - a[1], g[0] - a[0])
        starts.append([a[0], a[1], yaw])
        goals.append([g[0], g[1], yaw])
    return np.asarray(starts, np.float32), np.asarray(goals, np.float32)


# the fields of a PipelineResult the retry pass writes back, per lane
_RETRY_FIELDS = ("plan_success", "alm_converged", "res_h", "res_g", "non_hol",
                 "mean_track_err", "final_track_err")


def _accept(r: dict):
    """The harness's acceptance window on the reference's cap-exit flow
    (alm_traj_opt.cpp:265-278): small residuals, converged or not."""
    return (r["res_h"] < 5e-3) & (r["res_g"] < 0.05)


def _host(res: pipeline.PipelineResult) -> dict:
    out = {k: getattr(res, k).cpu().numpy().copy() for k in _RETRY_FIELDS}
    out["traj"] = SE2Traj(*[a.clone() for a in res.traj])
    return out


def _retry_config(scfg):
    """Easier settings for one retry of the failed lanes: a longer initial
    time, more outer rounds, a tenth of the time weight (a tuning
    objective, not a feasibility gate) and a deeper search."""
    r = dataclasses.replace
    return r(scfg,
             manager=r(scfg.manager, init_time_times=scfg.manager
                       .init_time_times * 1.5),
             alm=r(scfg.alm, max_iter=int(scfg.alm.max_iter * 2.5),
                   rho_T=scfg.alm.rho_T * 0.1),
             frontend=r(scfg.frontend,
                        max_rounds=scfg.frontend.max_rounds * 2))


def run_scene(name: str, B: int = 64, cache_dir: str = "data",
              n_track_steps: int = 500, seed: int = 0,
              lbfgs_overrides: dict | None = None, device=None) -> dict:
    """The scene's report (the JAX harness's keys) from one pipeline run of
    B sampled scenarios on `device` (None: CUDA), with one retry of the
    failed lanes at easier settings (`_retry_config`)."""
    dev = resolve_device(device)
    ovr = lbfgs_overrides or {"mem_size": 16, "max_iterations": 250}
    cached = name == "hill" or os.path.exists(
        os.path.join(cache_dir, f"{name}.npz"))
    t_map = time.perf_counter()
    scfg, grid = api.load_or_build_scene(name, cache_dir=cache_dir,
                                         device=dev)
    map_build_s = time.perf_counter() - t_map
    nx, ny, nyaw = grid.voxel_num
    n_fits = nx * ny * nyaw * scfg.map.iter_num
    grid = tgrid.with_pair_table(grid)
    rng = np.random.default_rng(seed)
    starts, goals = sample_free_scenarios(grid.occ_xy.cpu().numpy(),
                                          scfg.map, B, rng)
    shape = alm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
    run = lambda cfg, s, g: pipeline.plan_track_batch(
        grid, cfg, s, g, shape, n_track_steps=n_track_steps,
        lbfgs_overrides=ovr, device=dev)

    t0 = time.perf_counter()
    res = _host(run(scfg, starts, goals))
    wall = time.perf_counter() - t0
    ok = res["plan_success"] & _accept(res)

    n_retry, retried_ok = 0, 0
    fail = np.nonzero(~ok)[0]
    if fail.size:
        width = 8
        while width < fail.size:
            width *= 2
        pad = np.concatenate([fail, np.full(width - fail.size, fail[0])])
        rres = _host(run(_retry_config(scfg), starts[pad], goals[pad]))
        r_ok = (rres["plan_success"] & _accept(rres))[:fail.size]
        n_retry, retried_ok = int(fail.size), int(r_ok.sum())
        rec, sel = fail[r_ok], np.nonzero(r_ok)[0]
        for field in _RETRY_FIELDS:
            res[field][rec] = rres[field][sel]
        rec_t = torch.as_tensor(rec, device=dev)
        sel_t = torch.as_tensor(sel, device=dev)
        for full, part in zip(res["traj"], rres["traj"]):
            full[rec_t] = part[sel_t]
    accepted = _accept(res)
    ok = res["plan_success"] & accepted
    fe_fail = ~res["plan_success"]
    alm_fail = res["plan_success"] & ~accepted
    trk_bad = ok & ~np.isfinite(res["mean_track_err"])
    ok = ok & ~trk_bad

    # kinodynamic feasibility by the exact-semantics C++ A*: blind-sampled
    # scenarios can be unreachable under the curvature and occupancy
    # constraints, where the reference aborts too, so the rates are also
    # reported on the feasible subset (raises when the oracle cannot build)
    feasible = np.array([
        native.kino_astar_plan(grid, scfg.frontend, starts[i], goals[i])
        is not None for i in range(B)])
    on_feasible = lambda a: float(a[feasible].mean()) if feasible.any() \
        else None

    mm = {k: v.cpu().numpy() for k, v in max_metrics(
        res["traj"], grid, num_samples=1024).items()}
    conv = res["alm_converged"]
    a = scfg.alm

    def agg(key, lo=False):
        vals = mm[key][conv]
        if vals.size == 0:
            return None
        return float(vals.min() if lo else vals.max())

    return {
        "scene": name,
        "batch": B,
        "map_cells": [int(nx), int(ny), int(nyaw)],
        "map_cached": bool(cached),
        "map_build_s": map_build_s,
        "map_fits_per_sec": n_fits / map_build_s if not cached else None,
        "wall_s": wall,
        "frontend_success_rate": float(res["plan_success"].mean()),
        "alm_convergence_rate": float(conv.mean()),
        "alm_accepted_rate": float(accepted.mean()),
        "accept_criterion": "res_h<5e-3 & res_g<0.05 (alm_traj_opt.cpp:"
                            "265-278 cap-exit flow)",
        "failure_breakdown": {
            "frontend": int(fe_fail.sum()),
            "alm_residual": int(alm_fail.sum()),
            "tracking_nonfinite": int(trk_bad.sum()),
        },
        "retried_lanes": n_retry,
        "retry_recovered": retried_ok,
        "oracle_feasible_rate": float(feasible.mean()),
        "frontend_success_on_feasible": on_feasible(res["plan_success"]),
        "pipeline_success_on_feasible": on_feasible(ok),
        "res_h_p95": float(np.percentile(res["res_h"], 95)),
        "res_g_p95": float(np.percentile(res["res_g"], 95)),
        "pipeline_success_rate": float(ok.mean()),
        "mean_track_err_m": float(res["mean_track_err"][ok].mean())
        if ok.any() else None,
        "final_track_err_m": float(res["final_track_err"][ok].mean())
        if ok.any() else None,
        "max_non_hol": float(np.abs(res["non_hol"][ok]).max())
        if ok.any() else None,
        "metrics": {
            "max_vx": agg("max_vx"), "bound_vx": a.max_vel,
            "max_ax": agg("max_ax"), "bound_ax": a.max_acc_lon,
            "max_ay": agg("max_ay"), "bound_ay": a.max_acc_lat,
            "max_kap": agg("max_cur"), "bound_kap": a.max_kap,
            "min_cxi": agg("min_cxi", lo=True), "bound_cxi": a.min_cxi,
            "max_sig": agg("max_sig"), "bound_sig": a.max_sig,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=["hill"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--track-steps", type=int, default=500)
    ap.add_argument("--cache-dir", default="data")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    reports = []
    for scene in args.scenes:
        rep = run_scene(scene, B=args.batch, cache_dir=args.cache_dir,
                        n_track_steps=args.track_steps)
        print(json.dumps(rep), flush=True)
        reports.append(rep)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"scenes": reports}, f, indent=1)


if __name__ == "__main__":
    main()
