"""Build and cache terrain maps of point-cloud scenes on the port (port of
`examples/build_maps.py`).

The map builder (`terrain/build.py:construct_map`, its sweep on the card)
replaces the reference's multi-minute per-cell KD-tree sweep
(uneven_map.cpp:317-417).  Each scene's cloud `maps/<scene>.pcd` is read
by the C++ reader (`utils/native.pcd_load`, falling back to
`io.load_scene_cloud`), the map is cached as `<out>/<scene>.npz` and, with
`--csv`, in the reference's CSV `.map` format (`native.map_csv_write`) for
cross-checking with the reference implementation.

    python -m uneven_planner_tpu_torch.examples.build_maps
        [--scenes desert forest ...] [--csv] [--out data/] [--chunk N]
        [--maps-dir maps/] [--device cpu]

It runs on the card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.config import MapConfig, scene_config
from uneven_planner_tpu_torch.terrain import build, io
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.utils import native

SCENES = ["desert", "forest", "mountain", "vocano"]


class SceneMap(NamedTuple):
    grid: tgrid.TerrainGrid
    n_points: int
    npz: str
    csv: str | None
    load_s: float
    build_s: float


def build_scene(scene: str, map_cfg: MapConfig, out: str = "data",
                csv: bool = False, chunk: int | None = None,
                maps_dir: str | None = None, device=None,
                log=print) -> SceneMap:
    """Read `maps_dir/<scene>.pcd` (None: `io.REFERENCE_MAPS_DIR`), build
    its map over `map_cfg` on `device` (None: the card), write
    `out/<scene>.npz` and with `csv` `out/<scene>.map`.  `chunk` caps the
    fits a dispatch (None: sized by the builder's memory budget)."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    try:
        cloud = native.pcd_load(os.path.join(
            maps_dir or io.REFERENCE_MAPS_DIR, f"{scene}.pcd"))
    except (IOError, RuntimeError, OSError):
        cloud = io.load_scene_cloud(scene, maps_dir)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = build.construct_map(cloud, map_cfg, chunk=chunk, device=dev)
    data = grid.data.cpu().numpy()
    t_build = time.perf_counter() - t0
    nx, ny, nyaw = grid.voxel_num
    n_fits = nx * ny * nyaw * map_cfg.iter_num
    log(f"[{scene}] {len(cloud)} pts -> {nx}x{ny}x{nyaw} grid; "
        f"load {t_load:.1f}s, {n_fits/1e6:.1f}M fits in "
        f"{t_build:.1f}s ({n_fits/max(t_build, 1e-9)/1e6:.2f}M fits/s)")
    npz = os.path.join(out, f"{scene}.npz")
    io.save_map_npz(npz, data)
    csv_path = None
    if csv:
        t0 = time.perf_counter()
        csv_path = os.path.join(out, f"{scene}.map")
        native.map_csv_write(csv_path, np.asarray(data, np.float64))
        log(f"[{scene}] CSV cache in {time.perf_counter()-t0:.1f}s")
    occ = float(grid.occ.float().mean())
    log(f"[{scene}] occupancy fraction {occ*100:.1f}%")
    return SceneMap(grid, len(cloud), npz, csv_path, t_load, t_build)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="+", default=SCENES)
    ap.add_argument("--out", default="data")
    ap.add_argument("--csv", action="store_true",
                    help="also write the reference CSV .map format")
    ap.add_argument("--chunk", type=int, default=None,
                    help="fits a dispatch (default: sized by the builder's "
                    "memory budget)")
    ap.add_argument("--maps-dir", default=None,
                    help="where <scene>.pcd lies (default: maps/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    for scene in args.scenes:
        build_scene(scene, scene_config(scene).map, out=args.out,
                    csv=args.csv, chunk=args.chunk, maps_dir=args.maps_dir,
                    device=args.device, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
