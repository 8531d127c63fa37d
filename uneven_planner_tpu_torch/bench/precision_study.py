"""float32 on the card against float64 on the CPU: the solution quality of
the flat ALM solve in each (port of
`uneven_planner_tpu/bench/precision_study.py`).

Solves one scenario batch in float32 on the device and in float64 on the
CPU and on the device (through the float64 instantiations of the terrain
kernels) and reports the converged
shares and their agreement, the largest final residuals, and the
jerk-cost and x gaps on the lanes both converged.

    python -m uneven_planner_tpu_torch.bench.precision_study [--batch 64]

prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from uneven_planner_tpu_torch import headline, resolve_device
from uneven_planner_tpu_torch.config import MapConfig, scene_config
from uneven_planner_tpu_torch.minco import uniform
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid


def _solve(x0s, bounds, cfg, shape, device, dtype, overrides):
    """The flat solve on `device` in `dtype` on the hill grid with its
    pair table; (result, jerk cost [B]) as numpy."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    grid = tgrid.with_pair_table(make_synthetic_grid(cfg.map, dtype=np_dtype,
                                                     device=device))
    to = lambda a: a.to(device, dtype)
    xs, bs = to(x0s), alm.tree_map(to, bounds)
    res = alm.solve_flat(xs, bs, shape, grid, cfg.alm,
                         lbfgs_overrides=overrides)
    with torch.no_grad():
        cT_xy, Tp_xy, cT_yaw, Tp_yaw, _ = alm._coeffs_norm_cm(res.x, bs,
                                                              shape)
        ops = alm._ops(shape, res.x)
        jerk = uniform.jerk_cost_norm_cm(cT_xy, Tp_xy, ops.q_xy) \
            + uniform.jerk_cost_norm_cm(cT_yaw, Tp_yaw, ops.q_yaw)
    out = {k: getattr(res, k).cpu().numpy()
           for k in ("x", "converged", "res_h", "res_g")}
    return out, jerk.cpu().numpy()


def _compare(a, jk_a, b, jk_b, suffix_a: str, suffix_b: str) -> dict:
    both = a["converged"] & b["converged"]
    rel = (np.abs(jk_a[both] - jk_b[both])
           / np.maximum(np.abs(jk_b[both]), 1e-9))
    return {
        f"conv_{suffix_a}": float(a["converged"].mean()),
        f"conv_{suffix_b}": float(b["converged"].mean()),
        "conv_agree": float((a["converged"] == b["converged"]).mean()),
        f"res_h_{suffix_a}_max": float(a["res_h"].max()),
        f"res_h_{suffix_b}_max": float(b["res_h"].max()),
        f"res_g_{suffix_a}_max": float(a["res_g"].max()),
        f"res_g_{suffix_b}_max": float(b["res_g"].max()),
        "jerk_rel_gap_p50": float(np.percentile(rel, 50))
        if both.any() else None,
        "jerk_rel_gap_max": float(rel.max()) if both.any() else None,
        "x_gap_p50": float(np.percentile(np.abs(
            a["x"][both] - b["x"][both]).max(axis=1), 50))
        if both.any() else None,
    }


def run_study(B: int = 64, piece_xy: int = 10, piece_yaw: int = 20,
              int_K: int = 16, seed: int = 0, device=None,
              map_cfg: MapConfig | None = None,
              overrides: dict | None = None) -> dict:
    """The JAX study's record (float32 on `device`, None meaning CUDA,
    against float64 on the CPU; same keys), and under "f64_card" the same
    comparison of float64 on `device` against float64 on the CPU.  The
    scenarios are the headline's straight-line draws in the order drawn
    (`headline.make_batch`, as the JAX study draws them); `map_cfg`
    replaces the hill's map (the tests' coarse grid)."""
    dev = resolve_device(device)
    cfg = scene_config("hill")
    if map_cfg is not None:
        cfg = dataclasses.replace(cfg, map=map_cfg)
    shape = alm.ProblemShape(piece_xy, piece_yaw, int_K)
    ov = overrides or {"mem_size": 16, "max_iterations": 30}
    x0s, bounds, _ = headline.make_batch(B, cfg, shape,
                                         np.random.default_rng(seed),
                                         sort=False, device="cpu",
                                         dtype=torch.float64)
    res32, jk32 = _solve(x0s, bounds, cfg, shape, dev, torch.float32, ov)
    res64, jk64 = _solve(x0s, bounds, cfg, shape, torch.device("cpu"),
                         torch.float64, ov)
    r, jk = _solve(x0s, bounds, cfg, shape, dev, torch.float64, ov)
    return {"batch": B, **_compare(res32, jk32, res64, jk64, "f32", "f64"),
            "f64_card": {**_compare(r, jk, res64, jk64, "card", "cpu"),
                         "x_gap_max": float(np.abs(r["x"]
                                                   - res64["x"]).max())}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    print(json.dumps(run_study(args.batch)))


if __name__ == "__main__":
    main()
