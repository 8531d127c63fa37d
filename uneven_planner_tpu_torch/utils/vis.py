"""Visualization exports of the terrain field and the front end's search
(port of `uneven_planner_tpu/utils/vis.py`).

ROS-free equivalents of the reference's visualization publishers: numpy
point and segment arrays (and small PLY / CSV writers) that a viewer or a
notebook can render, read from the port's grid and search arena on any
device.

  - `field_cloud`       the RXS2 map cloud: one point a free (x, y) cell at
                        a yaw slice, z the terrain height, intensity sigma
                        (UnevenMap::visCallback, uneven_map.cpp:189-220);
  - `normal_segments`   the zb surface-normal line list (p1 -> p1 +
                        1.5 res (zb, c), every 2nd cell each way,
                        uneven_map.cpp:181-215);
  - `so2_pose_markers`  the sparse SE(2) -> SE(3) lifted pose probes over
                        every yaw bin (uneven_map.cpp:222-265);
  - `occupancy_cloud`   the occupied cells of the yaw slice;
  - `expanded_nodes`    the search's expanded nodes
                        (KinoAstar::visExpanded, kino_astar.cpp:266-276)
                        from `kino_init.plan(..., with_arena=True)`;
  - `save_ply` / `save_csv`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _slice(grid, yaw: float):
    """(data [nx, ny, 4], occ [nx, ny], cell centres X, Y) of the yaw slice
    nearest `yaw`."""
    nx, ny, nyaw = grid.voxel_num
    ox, oy, oyaw = grid.origin
    w = int(np.clip(math.floor((yaw - oyaw) / grid.yaw_resolution),
                    0, nyaw - 1))
    xs = (np.arange(nx) + 0.5) * grid.xy_resolution + ox
    ys = (np.arange(ny) + 0.5) * grid.xy_resolution + oy
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    return _np(grid.data[:, :, w]), _np(grid.occ[:, :, w]), X, Y


def field_cloud(grid, yaw: float = 0.0):
    """[N, 4] (x, y, z, sigma) of the free cells of the yaw slice nearest
    `yaw` (the reference publishes one fixed slice)."""
    data, occ, X, Y = _slice(grid, yaw)
    free = ~occ
    return np.stack([X[free], Y[free], data[..., 0][free],
                     data[..., 1][free]], axis=1)


def occupancy_cloud(grid, yaw: float = 0.0):
    """[N, 3] occupied cell centres of the yaw slice (z from the field)."""
    data, occ, X, Y = _slice(grid, yaw)
    return np.stack([X[occ], Y[occ], data[..., 0][occ]], axis=1)


def normal_segments(grid, yaw: float = 0.0, stride: int = 2):
    """[M, 2, 3] zb line segments: cell centre -> centre + 1.5 res (zb, c),
    every `stride`-th cell each way."""
    data, occ, X, Y = _slice(grid, yaw)
    data, occ = data[::stride, ::stride], occ[::stride, ::stride]
    X, Y = X[::stride, ::stride], Y[::stride, ::stride]
    free = ~occ
    zb = data[..., 2:4]
    c = np.sqrt(np.maximum(1.0 - np.sum(zb * zb, axis=-1), 0.0))
    p1 = np.stack([X[free], Y[free], data[..., 0][free]], axis=1)
    d = 1.5 * grid.xy_resolution
    p2 = p1 + d * np.stack([zb[..., 0][free], zb[..., 1][free], c[free]],
                           axis=1)
    return np.stack([p1, p2], axis=1)


def so2_pose_markers(grid, r_res: float = 0.8):
    """(points [M, 3], segments [M, 2, 3]): the lifted pose probes over
    every yaw bin of every `r_res`-th cell: the probe r_res / 2.5 along the
    heading, z lowered by the body x axis' z times 0.12, and the zb segment
    from each probe (uneven_map.cpp:222-265)."""
    nx, ny, nyaw = grid.voxel_num
    ox, oy, oyaw = grid.origin
    step = max(int(math.floor(r_res / grid.xy_resolution)), 1)
    data = _np(grid.data)
    pts, segs = [], []
    for xi in range(0, nx, step):
        for yi in range(0, ny, step):
            px = (xi + 0.5) * grid.xy_resolution + ox
            py = (yi + 0.5) * grid.xy_resolution + oy
            for wi in range(nyaw):
                pyaw = (wi + 0.5) * grid.yaw_resolution + oyaw
                rs2 = data[xi, yi, wi]
                zb = np.array([rs2[2], rs2[3],
                               math.sqrt(max(1.0 - rs2[2] ** 2
                                             - rs2[3] ** 2, 0.0))])
                xyaw = np.array([math.cos(pyaw), math.sin(pyaw), 0.0])
                yb = np.cross(zb, xyaw)
                nyb = np.linalg.norm(yb)
                yb = yb / (nyb if nyb > 0 else 1.0)
                xb = np.cross(yb, zb)
                p0 = np.array([px + r_res / 2.5 * math.cos(pyaw),
                               py + r_res / 2.5 * math.sin(pyaw),
                               rs2[0] - xb[2] * 0.12])
                pts.append(p0)
                segs.append([p0, p0 + 1.5 * grid.xy_resolution * zb])
    return np.asarray(pts), np.asarray(segs)


def expanded_nodes(arena_xyz, arena_parent):
    """[M, 3] SE(2) states of one scenario's arena entries that were
    expanded (parent >= 0; entry 0 is the start): `arena[b]` and
    `arena_parent[b]` of `kino_init.plan(..., with_arena=True)`."""
    a, par = _np(arena_xyz), _np(arena_parent)
    keep = par >= 0
    keep[0] = True
    return a[keep]


def save_csv(path: str, arr: np.ndarray, header: str = ""):
    np.savetxt(path, arr.reshape(arr.shape[0], -1), delimiter=",",
               header=header, comments="")


def save_ply(path: str, pts: np.ndarray, intensity: np.ndarray | None = None):
    """ASCII PLY point cloud (positions and an optional scalar named
    intensity)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {pts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if intensity is not None:
            f.write("property float intensity\n")
        f.write("end_header\n")
        for i in range(pts.shape[0]):
            row = f"{pts[i, 0]:.5f} {pts[i, 1]:.5f} {pts[i, 2]:.5f}"
            if intensity is not None:
                row += f" {float(intensity[i]):.6f}"
            f.write(row + "\n")
