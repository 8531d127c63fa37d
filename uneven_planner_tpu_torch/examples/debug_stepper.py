"""Optimization debug stepper on the port (port of
`examples/debug_stepper.py`): the reference's `in_debug` analog.

The reference publishes the intermediate trajectory after every L-BFGS
iteration with a 20 ms sleep so RViz can animate the solve (reference:
src/uneven_planner/back_end/src/alm_traj_opt.cpp:993-1017).  Here
`alm.debug_iterates` records every evaluation's iterate on the hill, and
every 8th recorded iterate's trajectory is sampled at 40 times into a CSV
(eval, fval, t, x, y, yaw) for plotting.

    python -m uneven_planner_tpu_torch.examples.debug_stepper [out.csv]
        [--device cpu]

It runs on the card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from uneven_planner_tpu_torch import manager, resolve_device
from uneven_planner_tpu_torch.config import MapConfig, scene_config
from uneven_planner_tpu_torch.minco import traj as mtraj
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

SHAPE = alm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
MAX_EVALS = 192
LBFGS_OVERRIDES = {"mem_size": 16, "max_iterations": 30}
EVERY = 8          # the CSV samples every EVERY-th recorded evaluation
TIMES = 40         # at TIMES times over the trajectory's duration
COLUMNS = "eval,fval,t,x,y,yaw"


class StepperResult(NamedTuple):
    rec: dict        # debug_iterates' rows of the one lane, on the host
    rows: list       # (eval, fval, t, x, y, yaw) tuples written to `out`


def fixed_path() -> np.ndarray:
    """The stepper's 16-point straight path from (-3, -3) to (-0.5, -1)."""
    t = np.linspace(0, 1, 16)[:, None]
    return np.concatenate(
        [(1 - t) * np.array([-3.0, -3.0]) + t * np.array([-0.5, -1.0]),
         np.full((16, 1), np.arctan2(2.0, 2.5))], axis=1)


def run(map_cfg: MapConfig | None = None, out: str = "debug_iterates.csv",
        device=None, dtype=np.float32, log=print) -> StepperResult:
    """`alm.debug_iterates` of the fixed path on the hill over `map_cfg`
    (None: the hill's) with the pair table, on `device` (None: the card),
    and the CSV of sampled intermediate trajectories."""
    dev = resolve_device(device)
    cfg = scene_config("hill")
    grid = tgrid.with_pair_table(make_synthetic_grid(
        map_cfg or cfg.map, dtype=dtype, device=dev))
    x0, bound = manager.init_guess_fixed(fixed_path(), cfg.manager,
                                         SHAPE.piece_xy, SHAPE.piece_yaw)
    tdtype = grid.data.dtype
    lane = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=tdtype) \
        .to(dev)
    x0, bound = lane(x0), alm.Boundary(*map(lane, bound))

    rec = alm.debug_iterates(x0, bound, SHAPE, grid, cfg.alm,
                             max_evals=MAX_EVALS,
                             lbfgs_overrides=LBFGS_OVERRIDES)
    rec = {k: v[0].cpu().numpy() for k, v in rec.items()}
    n_valid = int(rec["valid"].sum())
    log(f"recorded {n_valid} evaluations "
        f"(outer rounds: {rec['outer'][rec['valid']].max() + 1})")

    # sample each EVERY-th iterate's trajectory at TIMES points
    idx = list(range(0, n_valid, EVERY))
    xs = torch.as_tensor(rec["x"][idx]).to(dev)
    n = len(idx)
    bn = alm.tree_map(lambda a: a.expand((n,) + a.shape[1:]), bound)
    c_xy, ts_xy, c_yaw, ts_yaw, T = alm._coeffs(xs, bn, SHAPE)
    tr = mtraj.SE2Traj(c_xy=c_xy, ts_xy=ts_xy, c_yaw=c_yaw, ts_yaw=ts_yaw)
    u = torch.linspace(0.0, 1.0, TIMES, dtype=tdtype, device=dev)
    t = u[None] * T[:, None]
    p = mtraj.se2_pos(tr, t).cpu().numpy()
    t = t.cpu().numpy()
    rows = [(i, float(rec["f"][i]), float(t[k, j]), float(p[k, j, 0]),
             float(p[k, j, 1]), float(p[k, j, 2]))
            for k, i in enumerate(idx) for j in range(TIMES)]
    with open(out, "w") as f:
        f.write(COLUMNS + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    log(f"wrote {len(rows)} rows to {out}")
    return StepperResult(rec, rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="debug_iterates.csv")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    run(out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
