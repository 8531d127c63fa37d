"""The headline workload of the JAX package's `bench.py` (bench.py:182-351),
driven through the port: a batch of hill scenarios, nearest-pilot warm
duals, and the compacted flat solve.

`make_batch` and `harvest_warm` are own copies of `bench.make_batch` and
`bench._harvest_warm`, drawing the same random numbers in the same order, so
both packages solve the same scenarios from the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from uneven_planner_tpu_torch import manager, resolve_device
from uneven_planner_tpu_torch.config import MapConfig, SceneConfig, scene_config
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import (hill_height,
                                                        make_synthetic_grid)


@dataclasses.dataclass(frozen=True)
class HeadlineConfig:
    """Solver settings of the headline (bench.py:231-246, 299)."""
    batch: int = 4096
    pilot: int = 512
    piece_xy: int = 10
    piece_yaw: int = 20
    int_K: int = 8
    chunk_steps: int = 128
    buckets: tuple = (1, 4, 16)
    max_dispatch: int = 4096
    retry_width: int | None = None
    mem_size: int = 8
    max_iterations: int = 30

    @property
    def shape(self) -> alm.ProblemShape:
        return alm.ProblemShape(self.piece_xy, self.piece_yaw, self.int_K)

    @property
    def overrides(self) -> dict:
        return {"mem_size": self.mem_size,
                "max_iterations": self.max_iterations}


# the fast tables `scene_setup` can attach beside the pair table
# (bench.py:164-178, there the environment variable BENCH_TABLE)
TABLES = {"f16": tgrid.with_packed_f16, "packed": tgrid.with_packed_table,
          "pair": lambda grid: grid}


def scene_setup(map_cfg: MapConfig | None = None, device=None,
                table: str = "f16", dtype=np.float32):
    """(SceneConfig, hill grid in `dtype` (float32 by default) with the pair
    table and the fast table `table`): "f16" the f16 table (2 six-word rows
    a lookup, field error ~2.5e-4), "packed" the split-bf16 table (2
    twelve-word rows, <= 4e-6), "pair" none, so the solver iterates on the
    exact table."""
    if table not in TABLES:
        raise ValueError(f"table {table!r}: one of {', '.join(TABLES)}")
    cfg: SceneConfig = scene_config("hill")
    if map_cfg is not None:
        cfg = dataclasses.replace(cfg, map=map_cfg)
    grid = make_synthetic_grid(cfg.map, dtype=dtype, device=device)
    return cfg, TABLES[table](tgrid.with_pair_table(grid))


def make_batch(B, cfg: SceneConfig, shape: alm.ProblemShape, rng,
               sort: bool = True, device=None, dtype=torch.float32):
    """B straight-line hill scenarios -> (x0s [B, n] in `dtype`, Boundary,
    feats [B, 19] numpy).  Same draws as bench.make_batch."""
    dev = resolve_device(device)
    x0s, bounds, feats = [], [], []
    for _ in range(B):
        ang = rng.uniform(-np.pi, np.pi)
        start = rng.uniform(-3.5, -1.5, size=2)
        goal = np.clip(start + 2.5 * np.array([np.cos(ang), np.sin(ang)]),
                       -4.0, 4.0)
        yaw = np.arctan2(goal[1] - start[1], goal[0] - start[0])
        t = np.linspace(0, 1, 16)[:, None]
        path = np.concatenate([(1 - t) * start + t * goal,
                               np.full((16, 1), yaw)], axis=1)
        xi, bi = manager.init_guess_fixed(path, cfg.manager,
                                          piece_xy=shape.piece_xy,
                                          piece_yaw=shape.piece_yaw)
        x0s.append(xi)
        bounds.append(bi)
        zs = hill_height(path[:, 0], path[:, 1])
        ln = np.linalg.norm(goal - start)
        # centered 16-point terrain profile + length + heading (cos, sin):
        # difficulty sort key and nearest-pilot feature
        feats.append(np.concatenate([zs - zs.mean(),
                                     [ln, np.cos(yaw), np.sin(yaw)]]))
    x0s = np.stack(x0s)
    feats = np.asarray(feats)
    if sort:
        # difficulty-sorted dispatch: lanes ordered by terrain relief
        order = np.argsort(np.abs(np.diff(feats[:, :16], axis=1)).sum(1))
        x0s = x0s[order]
        bounds = [bounds[i] for i in order]
        feats = feats[order]
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    bound = alm.Boundary(*[to(np.stack([getattr(b, f) for b in bounds]))
                           for f in alm.Boundary._fields])
    return to(x0s), bound, feats


def solve(x0s, bounds, cfg: SceneConfig, grid, hc: HeadlineConfig,
          warm_duals=None, return_duals: bool = False) -> alm.ALMResult:
    """The headline's compacted flat solve of one batch."""
    return alm.solve_flat_compacted(
        x0s, bounds, hc.shape, grid, cfg.alm, lbfgs_overrides=hc.overrides,
        chunk_steps=hc.chunk_steps, buckets=hc.buckets,
        max_dispatch=hc.max_dispatch, retry_width=hc.retry_width,
        warm_duals=warm_duals, return_duals=return_duals)


def harvest_warm(cfg: SceneConfig, grid, hc: HeadlineConfig, rng,
                 device=None):
    """Nearest-pilot warm duals (bench.py:249-287): solve `hc.pilot`
    scenarios cold and return feats -> DualState giving each lane the final
    (lam, mu, rho) of its nearest converged pilot by scenario feature.
    None when fewer than 90% of the pilots converged."""
    dev = resolve_device(device)
    px, pb, pf = make_batch(hc.pilot, cfg, hc.shape, rng, sort=False,
                            device=dev)
    res = solve(px, pb, cfg, grid, hc, return_duals=True)
    conv = res.converged.cpu().numpy()
    if conv.mean() < 0.9:
        return None
    sel = torch.as_tensor(np.nonzero(conv)[0], device=dev)
    plam, pmu, prho = (a[sel] for a in res.duals)
    pfeat = pf[conv]
    sc = np.concatenate([np.ones(16), [0.5, 0.3, 0.3]])

    def warm_for(feats):
        d = np.linalg.norm((feats[:, None, :] - pfeat[None, :, :]) * sc,
                           axis=-1)
        nn = torch.as_tensor(np.argmin(d, axis=1), device=dev)
        return alm.DualState(lam=plam[nn], mu=pmu[nn], rho=prho[nn])
    return warm_for
