"""Build cells: whole terrain-map builds of a hill cloud, one build a unit.

Set-up draws the hill's cloud from the seed and prepares it as the
program's loader does (crop, 1 cm voxel filter); every build of the window
reads that cloud moved by a rigid shift of a few millimetres drawn for the
build, so no two builds of a run read the same input.  A unit is
`terrain.build.construct_map` over the full map, ended by reading the
occupancy on the host.  Each build keeps the cells drawn for it from the
seed; after the window the plain reference (`reference/build.py`) fits
those cells again from the same cloud.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import traffic as gen  # noqa: E402
from benchmark.reference import build as ref  # noqa: E402
from benchmark.reference.arith import Arith  # noqa: E402


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic = cell.traffic
        self.map_dict = cell.config["map"]
        self.kept = []

    def setup(self) -> dict:
        """Imports, the cloud, and one warm-up build; returns the seconds
        of each part."""
        t0 = time.perf_counter()
        from uneven_planner_tpu_torch.config import MapConfig
        from uneven_planner_tpu_torch.terrain import build, io
        self.build = build
        self.map = MapConfig(**self.map_dict)
        t1 = time.perf_counter()
        raw = gen.hill_cloud(self.traffic, self.seed)
        t2 = time.perf_counter()
        self.points = io.voxel_downsample(io.crop_box(raw))
        t3 = time.perf_counter()
        self.builds = -1
        self._build()              # the warm-up, build -1: builds kernels
        self.builds = 0
        return {"program_import_s": t1 - t0, "cloud_s": t2 - t1,
                "cloud_filter_s": t3 - t2,
                "warm_build_s": time.perf_counter() - t3}

    def _build(self):
        pts = self.points + gen.build_shift(self.traffic, self.seed,
                                            self.builds)
        t = {}
        grid = self.build.construct_map(pts, self.map,
                                        mode=self.traffic["mode"],
                                        device=self.device, timings=t)
        occ = grid.occ.cpu()                       # the host read
        return grid, occ, t

    def start_counting(self):
        self.count = {"builds": 0, "host_s": 0.0, "device_s": 0.0}

    def unit(self) -> int:
        grid, occ, t = self._build()
        ids = gen.build_sampled_cells(self.traffic, self.seed, self.builds,
                                      self.map.voxel_num)
        ix, iy, iw = (torch.as_tensor(ids[:, k]) for k in range(3))
        dev_ids = [a.to(self.device) for a in (ix, iy, iw)]
        self.kept.append((self.builds, ids,
                          grid.data[dev_ids[0], dev_ids[1], dev_ids[2]]
                          .double().cpu(), occ[ix, iy, iw]))
        self.count["builds"] += 1
        self.count["host_s"] += t["host_s"]
        self.count["device_s"] += t["device_s"]
        self.builds += 1
        return 1

    def counters(self) -> dict:
        return dict(self.count)

    def attempted_failed(self):
        return self.count["builds"], 0

    def end_to_end(self, win) -> dict:
        return {"builds_per_s": win.rate()}

    def release(self):
        self.build = None

    def positions(self, ids: np.ndarray) -> torch.Tensor:
        """Cell centres [n, 3] (x, y, yaw) of cell indices [n, 3]: the
        map spans its x and y sizes and 2 pi + 0.05 of yaw
        (uneven_map.cpp:96), centred on the origin."""
        m = self.map_dict
        res = np.array([m["xy_resolution"], m["xy_resolution"],
                        m["yaw_resolution"]])
        origin = -0.5 * np.array([m["map_size_x"], m["map_size_y"],
                                  2 * np.pi + 5e-2])
        return torch.as_tensor((ids + 0.5) * res + origin,
                               device=self.device)

    def readings(self, arith: Arith | None = None) -> dict:
        """The numbers compared over every kept cell of every build: the
        program's fits against the float64 reference's, or with `arith`
        the reference in that arithmetic (the control) in the program's
        place.  Cells the reference marks ambiguous are left out and
        counted, and the occupancy of cells within rounding of its
        thresholds is not compared.  The normal is compared where the
        reference's map is free, the cells whose normal enters a plan's
        attitude and acceleration limits; an occupied cell is judged by
        its occupancy (a trunk's round section leaves its least
        eigenvector undetermined: float32's lies up to 3e-4 off
        float64's there).  Sigma is not compared apart: float32 computes
        it ~0.2% off float64 (its least eigenvalue is small), as far off
        as TF32 does, so no limit separates them; it enters the
        occupancy.  The normal's gap is compared times the reference's
        conditioning of it (`normal_gap_cond`): rounding the covariance
        by a share e of its trace moves the normal by about e over the
        two least eigenvalues' gap over the trace, so a cell whose points
        lie near a line reads a wide gap in any precision.  The raw gap
        and its cell (`normal_gap`, `normal_worst`) are read, not
        compared."""
        if not self.kept:
            raise RuntimeError("no build was kept for the comparison")
        gaps = {"z_gap": 0.0, "normal_gap_cond": 0.0, "normal_gap": 0.0,
                "occupancy_mismatch": 0}
        worst = None
        compared = ambiguous = 0
        for b, ids, fits, occ in self.kept:
            cloud = torch.as_tensor(
                self.points + gen.build_shift(self.traffic, self.seed, b),
                device=self.device)
            cells = self.positions(ids)
            want, amb, cond = ref.cell_fits(cloud, cells, self.map_dict)
            if arith is not None:
                fits, _, _ = ref.cell_fits(cloud, cells, self.map_dict, arith)
                occ = ref.occupied(fits, self.map_dict)
            keep = ~amb.cpu()
            fits, want = fits.to(self.device)[keep], want[keep]
            cond = cond[keep]
            occ_want = ref.occupied(want, self.map_dict)
            sure = ~ref.near_threshold(want, self.map_dict).cpu()
            inf = float("inf")
            dz = torch.nan_to_num((fits[:, 0] - want[:, 0]).abs(), nan=inf)
            dn = torch.nan_to_num(torch.linalg.vector_norm(
                ref.normals(fits) - ref.normals(want), dim=-1), nan=inf)
            if dz.numel():
                gaps["z_gap"] = max(gaps["z_gap"], float(dz.max()))
            free = ~occ_want
            if free.any():
                gaps["normal_gap_cond"] = max(gaps["normal_gap_cond"], float(
                    (dn * cond)[free].max()))
                i = int(torch.argmax(torch.where(free, dn, -1.0)))
                if float(dn[i]) > gaps["normal_gap"]:
                    gaps["normal_gap"] = float(dn[i])
                    worst = [float(dn[i]), float(cond[i]), b,
                             *ids[keep.numpy()][i].tolist()]
            occ_want = occ_want.cpu()
            gaps["occupancy_mismatch"] += int(
                (occ.cpu()[keep] != occ_want)[sure].sum())
            compared += int(keep.sum())
            ambiguous += int(amb.sum())
        gaps["normal_worst"] = worst
        return dict(gaps, compared=compared, ambiguous=ambiguous)
