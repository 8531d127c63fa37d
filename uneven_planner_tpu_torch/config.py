"""Typed configuration for the planner (own copy of the JAX package's
`config.py`, limited to what the ported slice reads).

Field names and defaults mirror the reference YAML (run_hill.yaml and
siblings), exactly as in `uneven_planner_tpu/config.py`.  The MPC config
joins when that module is ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Terrain-map construction / lookup parameters (run_hill.yaml:2-14,
    uneven_map.cpp:73-121)."""

    iter_num: int = 2
    map_size_x: float = 10.0
    map_size_y: float = 10.0
    ellipsoid_x: float = 0.2
    ellipsoid_y: float = 0.1
    ellipsoid_z: float = 0.1
    xy_resolution: float = 0.05
    yaw_resolution: float = 0.1
    min_cnormal: float = 0.8
    max_rho: float = 0.05
    gravity: float = 9.81
    mass: float = 1.0
    probe_offset: float = 0.12

    @property
    def map_size_yaw(self) -> float:
        # uneven_map.cpp:96: map_size[2] = 2π + 5e-2
        return 2.0 * math.pi + 5e-2

    @property
    def map_origin(self) -> Tuple[float, float, float]:
        return (-self.map_size_x / 2.0, -self.map_size_y / 2.0,
                -self.map_size_yaw / 2.0)

    @property
    def voxel_num(self) -> Tuple[int, int, int]:
        return (int(math.ceil(self.map_size_x / self.xy_resolution)),
                int(math.ceil(self.map_size_y / self.xy_resolution)),
                int(math.ceil(self.map_size_yaw / self.yaw_resolution)))


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Kinodynamic initializer parameters (run_hill.yaml:16-30; scoring
    weights, lattice controls and collision interval as in
    kino_astar.cpp:138-195)."""

    yaw_resolution: float = 3.15
    lambda_heu: float = 1.0
    weight_r2: float = 1.0
    weight_so2: float = 0.5
    weight_v_change: float = 0.0
    weight_delta_change: float = 0.0
    weight_sigma: float = 10.0
    time_interval: float = 0.3
    collision_interval: float = 0.06
    oneshot_range: float = 1.0
    wheel_base: float = 0.26
    max_steer: float = 0.5
    max_vel: float = 0.5
    # batched-search sizing: frontier states expanded per round, max rounds
    frontier_size: int = 1024
    max_rounds: int = 160
    # dedup cell size; None -> min(map resolution, half the per-round arc
    # progress), so a primitive always escapes its cell
    dedup_resolution: float | None = None
    # yaw bin width of the search dedup (finer than the reference's 3.15 rad
    # half-plane bins, which cannot represent wall-following maneuvers)
    dedup_yaw_resolution: float = 0.6


@dataclasses.dataclass(frozen=True)
class ALMConfig:
    """PHR-ALM + L-BFGS trajectory-optimizer parameters
    (run_hill.yaml:32-55, alm_traj_opt.cpp:5-29)."""

    rho_T: float = 100000.0
    rho_ter: float = 10.0
    max_vel: float = 0.5
    max_acc_lon: float = 5.0
    max_acc_lat: float = 10.0
    max_kap: float = 2.1
    min_cxi: float = 0.8
    max_sig: float = 0.05
    use_scaling: bool = True
    rho: float = 1.0
    beta: float = 1000.0
    gamma: float = 1.0
    epsilon_con: float = 1.0e-3
    max_iter: int = 10
    g_epsilon: float = 1.0e-3
    min_step: float = 1.0e-32
    inner_max_iter: int = 10000
    delta: float = 1.0e-4
    mem_size: int = 256
    past: int = 3
    int_K: int = 16
    # constants baked into the reference sources (alm_traj_opt.h:16-19)
    delta_sigl: float = 0.01
    cur_scale: float = 10.0
    sig_scale: float = 1000.0
    scale_trick_jerk: float = 1000.0
    # L-BFGS line-search constants (lbfgs.hpp:76-128)
    max_linesearch: int = 64
    f_dec_coeff: float = 1.0e-4
    s_curv_coeff: float = 0.9
    cautious_factor: float = 1.0e-6
    machine_prec: float = 1.0e-16
    # noise-tolerant Armijo slack (solver.lbfgs.LBFGSParams.f_noise_rel)
    f_noise_rel: float = 0.0


@dataclasses.dataclass(frozen=True)
class ManagerConfig:
    """Init-guess construction parameters (run_hill.yaml:57-62)."""

    piece_len: float = 0.3
    mean_vel: float = 0.5
    init_time_times: float = 1.2
    yaw_piece_times: float = 2.0
    init_sig_vel: float = 0.05


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    name: str = "hill"
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    frontend: FrontendConfig = dataclasses.field(
        default_factory=FrontendConfig)
    alm: ALMConfig = dataclasses.field(default_factory=ALMConfig)
    manager: ManagerConfig = dataclasses.field(default_factory=ManagerConfig)


def scene_config(name: str) -> SceneConfig:
    """Per-scene presets (run_vocano.yaml:12,40; run_forest.yaml:12,33,40-41;
    hill/desert/mountain share the base config)."""
    base = SceneConfig(name=name)
    if name in ("hill", "desert", "mountain"):
        return base
    if name in ("vocano", "volcano"):
        return dataclasses.replace(
            base,
            name="vocano",
            map=dataclasses.replace(base.map, max_rho=0.08),
            alm=dataclasses.replace(base.alm, max_sig=0.08),
        )
    if name == "forest":
        return dataclasses.replace(
            base,
            map=dataclasses.replace(base.map, max_rho=0.001),
            alm=dataclasses.replace(
                base.alm, max_sig=0.001, rho_T=500.0, use_scaling=False),
        )
    raise ValueError(f"unknown scene: {name}")
