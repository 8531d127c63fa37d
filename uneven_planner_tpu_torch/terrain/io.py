"""Point-cloud and terrain-map IO (port of `uneven_planner_tpu/terrain/
io.py`; numpy, on the host).

Replaces the reference's PCL pipeline (uneven_map.cpp:127-163: PCDReader +
CropBox(+-10 m, z in [-0.01, 5]) + VoxelGrid 1 cm) with a dependency-free
reader and filters, and implements both map caches: the reference's CSV
`<scene>.map` (x,y,yaw,z,sigma,zb0,zb1 per line, uneven_map.cpp:400-412)
and an .npz tensor cache.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# The reference's scene clouds (its src/uneven_planner/uneven_map/maps/
# <scene>.pcd), looked for in `maps/` beside the package.
REFERENCE_MAPS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "maps")


def read_pcd(path: str) -> np.ndarray:
    """Minimal PCD v0.7 reader (ascii + binary), returning [N, 3] xyz."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key] = rest.split()
            if key == "DATA":
                data_mode = rest.strip()
                break
        fields = header["FIELDS"]
        sizes = list(map(int, header["SIZE"]))
        types = header["TYPE"]
        counts = list(map(int, header.get("COUNT", ["1"] * len(fields))))
        n_points = int(header["POINTS"][0])

        np_types = []
        for fname, sz, tp, cnt in zip(fields, sizes, types, counts):
            base = {"F": "f", "I": "i", "U": "u"}[tp] + str(sz)
            for c in range(cnt):
                suffix = f"_{c}" if cnt > 1 else ""
                np_types.append((fname + suffix, base))
        dtype = np.dtype(np_types)

        if data_mode == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            arr = np.rec.fromarrays(body.T, dtype=dtype)
        elif data_mode == "binary":
            arr = np.frombuffer(f.read(n_points * dtype.itemsize),
                                dtype=dtype, count=n_points)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode}")

    return np.stack([arr["x"], arr["y"], arr["z"]],
                    axis=1).astype(np.float64)


def crop_box(points: np.ndarray,
             lo=(-10.0, -10.0, -0.01), hi=(10.0, 10.0, 5.0)) -> np.ndarray:
    """CropBox filter (uneven_map.cpp:133-137)."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    m = np.all((points >= lo) & (points <= hi), axis=1)
    return points[m]


def voxel_downsample(points: np.ndarray, leaf: float = 0.01) -> np.ndarray:
    """Centroid voxel-grid filter (uneven_map.cpp:140-143, 1 cm leaf)."""
    keys = np.floor(points / leaf).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv.reshape(-1), points)
    return sums / counts[:, None]


def load_scene_cloud(scene: str, maps_dir: str | None = None) -> np.ndarray:
    """Cropped and downsampled world cloud of `maps_dir/<scene>.pcd`
    (maps_dir None: REFERENCE_MAPS_DIR)."""
    path = os.path.join(maps_dir or REFERENCE_MAPS_DIR, f"{scene}.pcd")
    return voxel_downsample(crop_box(read_pcd(path)))


# ---------------------------------------------------------------------------
# Map caches
# ---------------------------------------------------------------------------

def save_map_csv(path: str, data: np.ndarray) -> None:
    """Write the reference CSV cache (uneven_map.cpp:400-412).
    data: [Nx, Ny, Nyaw, 4] channels (z, sigma, zb0, zb1)."""
    nx, ny, nyaw, _ = data.shape
    with open(path, "w") as f:
        for x in range(nx):
            for y in range(ny):
                for yaw in range(nyaw):
                    z, sig, a, b = data[x, y, yaw]
                    f.write(f"{x},{y},{yaw},{z},{sig},{a},{b}\n")


def load_map_csv(path: str, voxel_num: Tuple[int, int, int]) -> np.ndarray:
    """Read a reference CSV cache into the [Nx, Ny, Nyaw, 4] tensor."""
    raw = np.loadtxt(path, delimiter=",")
    data = np.zeros(tuple(voxel_num) + (4,))
    idx = raw[:, :3].astype(np.int64)
    ok = np.all((idx >= 0) & (idx < np.asarray(voxel_num)), axis=1)
    idx = idx[ok]
    data[idx[:, 0], idx[:, 1], idx[:, 2]] = raw[ok, 3:7]
    return data


def save_map_npz(path: str, data: np.ndarray) -> None:
    np.savez_compressed(path, data=data)


def load_map_npz(path: str) -> np.ndarray:
    return np.load(path)["data"]
