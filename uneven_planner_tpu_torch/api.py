"""High-level API (port of `uneven_planner_tpu/api.py`): build a scene, plan
one or many trajectories from start and goal poses.

`plan_batch` is the planning path: batched kinodynamic search -> on-device
fixed-piece init guess -> batched flat ALM solve.  It runs on the card
unless the caller names another device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from uneven_planner_tpu_torch import manager, resolve_device
from uneven_planner_tpu_torch.config import SceneConfig, scene_config
from uneven_planner_tpu_torch.frontend import kino_init
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

# the point-cloud scenes of the reference, built from its maps/<name>.pcd
PCD_SCENES = ("desert", "mountain", "vocano", "volcano", "forest")


def load_or_build_scene(name: str, dtype=np.float32, device=None):
    """(SceneConfig, TerrainGrid) of a scene.  Only the synthetic hill is
    built here; the other scenes are fitted from the reference's point
    clouds by `terrain/build.py` of the JAX package, which is not ported
    yet."""
    scfg = scene_config(name)
    if name != "hill":
        raise NotImplementedError(
            f"scene {name!r} is built from the reference point cloud "
            f"maps/{scfg.name}.pcd by terrain/build.py of the JAX package, "
            "which this port does not have yet; only 'hill' can be built")
    return scfg, make_synthetic_grid(scfg.map, dtype=dtype, device=device)


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
