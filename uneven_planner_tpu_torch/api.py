"""High-level API (port of `uneven_planner_tpu/api.py`): build or load a
scene, plan one or many trajectories from start and goal poses.

`plan_batch` is the planning path: batched kinodynamic search -> on-device
fixed-piece init guess -> batched flat ALM solve.  It runs on the card
unless the caller names another device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from uneven_planner_tpu_torch import manager, resolve_device
from uneven_planner_tpu_torch.config import SceneConfig, scene_config
from uneven_planner_tpu_torch.frontend import kino_init
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain import build, io
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid


def load_or_build_scene(name: str, cache_dir: str = "data",
                        dtype=np.float32, device=None):
    """(SceneConfig, TerrainGrid) of a scene on `device` (None: CUDA): the
    synthetic hill, or a point-cloud scene built by `terrain/build.py` from
    its `maps/<name>.pcd` (`io.load_scene_cloud`) and cached as
    `cache_dir/<name>.npz`, the reference's .map-cache startup
    (uneven_map.cpp:166-167).  A scene whose cloud is missing raises the
    reader's FileNotFoundError, which names the path."""
    scfg = scene_config(name)
    dev = resolve_device(device)
    if name == "hill":
        return scfg, make_synthetic_grid(scfg.map, dtype=dtype, device=dev)
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"{name}.npz")
    if os.path.exists(cache):
        data = io.load_map_npz(cache)
    else:
        cloud = io.load_scene_cloud(name)
        data = build.construct_map(cloud, scfg.map, device=dev).data \
            .cpu().numpy()
        io.save_map_npz(cache, data)
    m = scfg.map
    grid = tgrid.from_buffers(
        torch.from_numpy(np.asarray(data, dtype)).to(dev), m.min_cnormal,
        m.max_rho, m.xy_resolution, m.yaw_resolution, m.map_origin,
        m.gravity)
    return scfg, grid


def _on(device, a, dtype) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype).to(device)


def plan_batch(grid, scfg: SceneConfig, starts, goals,
               shape: Optional[alm.ProblemShape] = None,
               lbfgs_overrides: Optional[dict] = None, device=None):
    """Plan B trajectories: starts, goals [B, 3] (x, y, yaw) -> (KinoResult,
    ALMResult) with a leading scenario dimension, lane for lane what the JAX
    package's `vmap(plan)` returns.  Scenarios whose search fails still go
    through the solve; read `success` and `converged`."""
    dev = resolve_device(device)
    if grid.device.type != dev.type:
        raise ValueError(f"the grid lies on {grid.device}, the plan was "
                         f"asked for on {dev}")
    dtype = grid.data.dtype
    shape = shape or alm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
    kres = kino_init.plan(grid, scfg.frontend, _on(dev, starts, dtype),
                          _on(dev, goals, dtype))
    x0, bound = manager.init_guess_fixed_device(
        kres.path, kres.path_mask, scfg.manager, shape.piece_xy,
        shape.piece_yaw)
    ares = alm.solve_flat(
        x0, bound, shape, grid, scfg.alm,
        lbfgs_overrides=lbfgs_overrides
        or {"mem_size": 8, "max_iterations": 250})
    return kres, ares


def plan(grid, scfg: SceneConfig, start, goal,
         shape: Optional[alm.ProblemShape] = None,
         lbfgs_overrides: Optional[dict] = None, device=None):
    """Plan one trajectory: `plan_batch` on a batch of one, with the
    scenario dimension kept (every field is [1, ...])."""
    one = lambda a: torch.as_tensor(a)[None]
    return plan_batch(grid, scfg, one(start), one(goal), shape,
                      lbfgs_overrides, device)
