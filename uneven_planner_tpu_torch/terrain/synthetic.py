"""Synthetic analytic terrains (port of `uneven_planner_tpu/terrain/
synthetic.py`).

The canonical "hill" terrain is a smooth sum-of-Gaussians height field whose
tangent-plane normals and flatness are computed in closed form on the
200x200x64 grid of run_hill.yaml:3-10.  The field is built in numpy exactly
as the JAX package builds it, then moved to the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.terrain import grid as tgrid


def hill_height(x, y):
    """Smooth hills on a 10x10 m patch, gradients well inside attitude
    limits except on the steep central mound."""
    return (0.55 * np.exp(-((x - 1.5) ** 2 + (y - 1.0) ** 2) / 2.8)
            + 0.45 * np.exp(-((x + 2.0) ** 2 + (y + 2.2) ** 2) / 3.5)
            + 0.9 * np.exp(-((x + 0.5) ** 2 + (y - 3.0) ** 2) / 0.6)
            + 0.05 * np.sin(1.3 * x) * np.cos(1.1 * y))


# peak of the pseudo-roughness sigma on steep slopes
ROUGHNESS = 0.012


def hill_data(cfg: MapConfig, dtype=np.float64,
              roughness: float = ROUGHNESS) -> np.ndarray:
    """[Nx, Ny, Nyaw, 4] RXS2 buffer: zb from the surface normal, sigma a
    smooth pseudo-roughness (peak `roughness`) with mild yaw dependence."""
    nx, ny, nyaw = cfg.voxel_num
    ox, oy, oyaw = cfg.map_origin
    xs = (np.arange(nx) + 0.5) * cfg.xy_resolution + ox
    ys = (np.arange(ny) + 0.5) * cfg.xy_resolution + oy
    yaws = (np.arange(nyaw) + 0.5) * cfg.yaw_resolution + oyaw
    X, Y = np.meshgrid(xs, ys, indexing="ij")

    Z = hill_height(X, Y)
    eps = 1e-4
    dzdx = (hill_height(X + eps, Y) - hill_height(X - eps, Y)) / (2 * eps)
    dzdy = (hill_height(X, Y + eps) - hill_height(X, Y - eps)) / (2 * eps)
    norm = np.sqrt(dzdx ** 2 + dzdy ** 2 + 1.0)
    slope2 = dzdx ** 2 + dzdy ** 2
    sigma_xy = roughness * slope2 / (1.0 + slope2)

    data = np.zeros((nx, ny, nyaw, 4), dtype=dtype)
    data[..., 0] = Z[:, :, None]
    data[..., 2] = (-dzdx / norm)[:, :, None]
    data[..., 3] = (-dzdy / norm)[:, :, None]
    data[..., 1] = sigma_xy[:, :, None] * (1.0 + 0.2 * np.cos(yaws)[None, None, :])
    return data


def make_synthetic_grid(cfg: MapConfig | None = None,
                        roughness: float = ROUGHNESS, dtype=np.float64,
                        device=None) -> tgrid.TerrainGrid:
    """Analytic hill TerrainGrid on `device` (None -> CUDA)."""
    cfg = cfg or MapConfig()
    dev = resolve_device(device)
    data = torch.from_numpy(hill_data(cfg, dtype, roughness)).to(dev)
    return tgrid.from_buffers(
        data, min_cnormal=cfg.min_cnormal, max_rho=cfg.max_rho,
        xy_resolution=cfg.xy_resolution, yaw_resolution=cfg.yaw_resolution,
        origin=cfg.map_origin, gravity=cfg.gravity)
