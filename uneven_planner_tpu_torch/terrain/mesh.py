"""Scene mesh -> point cloud (port of `uneven_planner_tpu/terrain/mesh.py`;
numpy, on the host).

The reference samples a scene mesh into the PCD the map builder reads
(its maps/to_pcl.py:1-25, open3d).  This module does the same without
open3d: OBJ, ASCII-STL and binary-STL loaders, area-weighted uniform
surface sampling, and an optional voxel thinning pass.
"""

from __future__ import annotations

import struct

import numpy as np

from uneven_planner_tpu_torch.terrain.io import voxel_downsample


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Vertices [V, 3] and triangle indices [F, 3] from a Wavefront OBJ
    (triangulates polygon faces as a fan)."""
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int64).reshape(-1, 3))


def load_stl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Vertices/faces from an STL file (binary or ASCII autodetected)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        try:
            return _load_stl_ascii(path)
        except ValueError:
            pass  # some binary STLs start with "solid"
    return _load_stl_binary(path)


def _load_stl_ascii(path: str):
    verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
    if not verts or len(verts) % 3:
        raise ValueError("not an ASCII STL")
    v = np.asarray(verts, np.float64)
    return v, np.arange(len(v), dtype=np.int64).reshape(-1, 3)


def _load_stl_binary(path: str):
    with open(path, "rb") as f:
        f.read(80)
        (n,) = struct.unpack("<I", f.read(4))
        raw = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
    tri = raw[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
    v = tri.reshape(-1, 3)
    return v, np.arange(len(v), dtype=np.int64).reshape(-1, 3)


def load_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    if path.lower().endswith(".obj"):
        return load_obj(path)
    if path.lower().endswith(".stl"):
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")


def sample_surface(verts: np.ndarray, faces: np.ndarray, n_points: int,
                   seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface sampling: pick triangles with
    probability proportional to area, then uniform barycentric points."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(faces), size=n_points, p=areas / total)
    r1 = np.sqrt(rng.random(n_points))[:, None]
    r2 = rng.random(n_points)[:, None]
    return (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]


def mesh_to_cloud(path: str, n_points: int = 300_000, leaf: float = 0.01,
                  seed: int = 0) -> np.ndarray:
    """Mesh file -> roughly uniform point cloud at `leaf` spacing (the
    reference's to_pcl.py samples 300k points; its map builder voxel-filters
    at 1 cm, uneven_map.cpp:138-143)."""
    verts, faces = load_mesh(path)
    pts = sample_surface(verts, faces, n_points, seed=seed)
    return voxel_downsample(pts, leaf=leaf)


def save_pcd(path: str, points: np.ndarray) -> None:
    """Write an ASCII PCD v0.7 file (read by `io.read_pcd` and by PCL)."""
    points = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                "COUNT 1 1 1\n"
                f"WIDTH {len(points)}\nHEIGHT 1\n"
                "VIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(points)}\nDATA ascii\n")
        np.savetxt(f, points, fmt="%.6f")
