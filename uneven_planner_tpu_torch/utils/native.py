"""ctypes binding of the reference-semantics C++ host library
(`native/src/uneven_host.cc`; port of `uneven_planner_tpu/utils/native.py`).

The library is the port's independent float64 oracle: the exact-semantics
A* (`kino_astar_plan`), MINCO s=3 (`minco_generate`, `minco_jerk_cost`),
the ALM inner cost (`inner_cost`), the Dubins distance, the PCD reader and
the reference's CSV map cache.  It is built at first use from the source in
the checkout with the system `g++ -O2 -std=c++17 -fPIC -Wall -shared` (the
flags of `native/Makefile`) into `_build/` beside the package, keyed by a
hash of the source and the flags; `native/` itself is never written.  The grids
are the port's `TerrainGrid`s on any device: their tensors are copied to
the host in float64 (uint8 for the occupancy) for each call.

`ensure_built()` says whether the library could be built; every other
function raises RuntimeError when it cannot.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "src",
                      "uneven_host.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class KinoParams(ctypes.Structure):
    _fields_ = [
        ("origin_x", ctypes.c_double), ("origin_y", ctypes.c_double),
        ("xy_resolution", ctypes.c_double),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int),
        ("nyaw_map", ctypes.c_int),
        ("yaw_map_resolution", ctypes.c_double),
        ("yaw_resolution", ctypes.c_double),
        ("lambda_heu", ctypes.c_double), ("weight_r2", ctypes.c_double),
        ("weight_so2", ctypes.c_double),
        ("weight_v_change", ctypes.c_double),
        ("weight_delta_change", ctypes.c_double),
        ("weight_sigma", ctypes.c_double),
        ("time_interval", ctypes.c_double),
        ("collision_interval", ctypes.c_double),
        ("oneshot_range", ctypes.c_double),
        ("wheel_base", ctypes.c_double), ("max_steer", ctypes.c_double),
        ("max_vel", ctypes.c_double),
        ("max_expansions", ctypes.c_int),
    ]


class InnerCostParams(ctypes.Structure):
    _fields_ = [
        ("nxy", ctypes.c_int), ("nyaw", ctypes.c_int), ("K", ctypes.c_int),
        ("jerk_scale", ctypes.c_double),
        ("sigma_weight", ctypes.c_double),
        ("time_weight", ctypes.c_double),
        ("max_vel", ctypes.c_double), ("max_acc_lon", ctypes.c_double),
        ("max_acc_lat", ctypes.c_double), ("max_kap", ctypes.c_double),
        ("min_cxi", ctypes.c_double), ("max_sig", ctypes.c_double),
        ("delta_sigl", ctypes.c_double), ("gravity", ctypes.c_double),
        ("gnx", ctypes.c_int), ("gny", ctypes.c_int),
        ("gnyaw", ctypes.c_int),
        ("origin_x", ctypes.c_double), ("origin_y", ctypes.c_double),
        ("origin_yaw", ctypes.c_double),
        ("xy_res", ctypes.c_double), ("yaw_res", ctypes.c_double),
    ]


def library_path() -> str:
    """Where the library built from SOURCE with CXX_FLAGS lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libuneven_host_{h.hexdigest()[:16]}.so")


def compiler() -> str | None:
    """The g++ on PATH, the system compiler, whose C++ runtime is the
    libstdc++ a Python process loads.  CXX is not read: a toolchain it
    names can build a library whose C++ runtime calls crash beside the
    system's libstdc++ (a machine with CXX=/opt/gcc/bin/g++ did so in
    `pcd_load`)."""
    return shutil.which("g++")


def _build() -> str:
    """Compile SOURCE unless built already; returns the library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native "
                           "library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE} ({r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of the library's C functions."""
    d, i, s = ctypes.c_double, ctypes.c_int, ctypes.c_char_p
    dp = ctypes.POINTER(ctypes.c_double)
    for name, res, args in (
            ("pcd_load", i, [s, dp, dp, d, dp, i]),
            ("map_csv_read", i, [s, i, i, i, dp]),
            ("map_csv_write", i, [s, i, i, i, dp]),
            ("kino_astar_plan", i, [ctypes.POINTER(KinoParams),
                                    ctypes.POINTER(ctypes.c_ubyte), dp, dp,
                                    dp, dp, i]),
            ("dubins_distance", d, [dp, dp, d]),
            ("minco_generate", i, [i, i, dp, dp, dp, dp, dp]),
            ("minco_jerk_cost", d, [i, i, dp, dp]),
            ("minco_inner_cost", d, [ctypes.POINTER(InnerCostParams)]
             + [dp] * 8 + [d, dp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            _declare(lib)
            _lib = lib
    return _lib


def ensure_built() -> bool:
    """Build and load the library if needed; whether it is available."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _host(a, shape=None) -> np.ndarray:
    """A C-contiguous float64 host copy of a tensor or an array, reshaped
    to `shape` (a size mismatch raises) so the C code reads no further."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a if shape is None else np.ascontiguousarray(a.reshape(shape))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def pcd_load(path: str, lo=(-10.0, -10.0, -0.01), hi=(10.0, 10.0, 5.0),
             leaf: float = 0.01, capacity: int = 2_000_000) -> np.ndarray:
    """Native PCD read + crop + centroid voxel filter -> [N, 3] float64."""
    lib = _load()
    out = np.empty((capacity, 3), dtype=np.float64)
    lo, hi = _host(lo, (3,)), _host(hi, (3,))
    n = lib.pcd_load(path.encode(), _dptr(lo), _dptr(hi),
                     ctypes.c_double(leaf), _dptr(out), capacity)
    if n < 0:
        raise IOError(f"pcd_load({path}) failed: {n}")
    return out[:n].copy()


def map_csv_read(path: str, voxel_num) -> np.ndarray:
    """The reference's CSV map cache -> [Nx, Ny, Nyaw, 4] float64."""
    lib = _load()
    nx, ny, nyaw = voxel_num
    out = np.zeros((nx, ny, nyaw, 4), dtype=np.float64)
    n = lib.map_csv_read(path.encode(), nx, ny, nyaw, _dptr(out))
    if n < 0:
        raise IOError(f"map_csv_read({path}) failed")
    return out


def map_csv_write(path: str, data) -> None:
    """Write [Nx, Ny, Nyaw, 4] (array or tensor) as the reference's CSV
    map cache, every value to 17 significant digits."""
    lib = _load()
    data = _host(data)
    nx, ny, nyaw, _ = data.shape
    n = lib.map_csv_write(path.encode(), nx, ny, nyaw, _dptr(data))
    if n < 0:
        raise IOError(f"map_csv_write({path}) failed")


def kino_astar_plan(grid, frontend_cfg, start, goal,
                    max_expansions: int = 500_000,
                    cap: int = 100_000) -> Optional[np.ndarray]:
    """Exact reference-semantics A* over a port TerrainGrid (the golden
    oracle of the batched search).  Returns the [L, 3] path or None."""
    lib = _load()
    nx, ny, nyaw = grid.voxel_num
    fe = frontend_cfg
    p = KinoParams(
        origin_x=grid.origin[0], origin_y=grid.origin[1],
        xy_resolution=grid.xy_resolution,
        nx=nx, ny=ny, nyaw_map=nyaw,
        yaw_map_resolution=grid.yaw_resolution,
        yaw_resolution=fe.yaw_resolution,
        lambda_heu=fe.lambda_heu,
        weight_r2=fe.weight_r2,
        weight_so2=fe.weight_so2,
        weight_v_change=fe.weight_v_change,
        weight_delta_change=fe.weight_delta_change,
        weight_sigma=fe.weight_sigma,
        time_interval=fe.time_interval,
        collision_interval=fe.collision_interval,
        oneshot_range=fe.oneshot_range,
        wheel_base=fe.wheel_base,
        max_steer=fe.max_steer,
        max_vel=fe.max_vel,
        max_expansions=max_expansions)
    occ = np.ascontiguousarray(grid.occ_xy.detach().cpu().numpy(),
                               dtype=np.uint8)
    sigma = _host(grid.data[..., 1])
    out = np.empty((cap, 3), dtype=np.float64)
    start, goal = _host(start, (3,)), _host(goal, (3,))
    n = lib.kino_astar_plan(
        ctypes.byref(p),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _dptr(sigma), _dptr(start), _dptr(goal), _dptr(out), cap)
    if n < 0:
        raise RuntimeError(f"kino_astar_plan error {n}")
    if n == 0:
        return None
    return out[:n].copy()


def minco_generate(inner, ts, head, tail) -> np.ndarray:
    """C++ MINCO s=3 generate (the twin of se2traj.hpp:595-680): inner
    [N-1, D], ts [N], head/tail [3, D] -> coefficients [N, 6, D] in
    ascending powers, float64."""
    lib = _load()
    ts = _host(ts)
    N = ts.shape[0]
    head = _host(head)
    D = head.shape[1]
    inner, tail = _host(inner, (N - 1, D)), _host(tail, (3, D))
    out = np.empty((N, 6, D), np.float64)
    r = lib.minco_generate(N, D, _dptr(inner), _dptr(ts), _dptr(head),
                           _dptr(tail), _dptr(out))
    if r != 0:
        raise RuntimeError(f"minco_generate error {r}")
    return out


def minco_jerk_cost(coeffs, ts) -> float:
    """C++ jerk cost of coefficients [N, 6, D] over durations ts [N]."""
    lib = _load()
    coeffs = _host(coeffs)
    N, _, D = coeffs.shape
    ts = _host(ts, (N,))
    return float(lib.minco_jerk_cost(N, D, _dptr(coeffs), _dptr(ts)))


def inner_cost(grid, alm_cfg, shape, x, bound, lam, mu, rho, scale_cx,
               scale_fx: float = 1.0) -> float:
    """C++ ALM inner-cost twin (innerCallback + calConstrainCostGrad
    forward, alm_traj_opt.cpp:280-347,663-991) at one lane's iterate.

    Arguments mirror `solver/alm.inner_cost` for one lane (a leading lane
    dimension of 1 is allowed): x [n], bound an `alm.Boundary`, lam [E], mu
    [I] channel-major, scale_cx [7, S] channel-major.  The C++ reads the
    bare `grid.data` with an exact trilinear blend."""
    lib = _load()
    nx, ny, nyaw = grid.voxel_num
    trick = alm_cfg.scale_trick_jerk if alm_cfg.use_scaling else 1.0
    p = InnerCostParams(
        nxy=shape.piece_xy, nyaw=shape.piece_yaw, K=shape.int_K,
        jerk_scale=float(scale_fx) * float(trick),
        sigma_weight=alm_cfg.rho_ter * float(scale_fx),
        time_weight=alm_cfg.rho_T * float(scale_fx),
        max_vel=alm_cfg.max_vel, max_acc_lon=alm_cfg.max_acc_lon,
        max_acc_lat=alm_cfg.max_acc_lat, max_kap=alm_cfg.max_kap,
        min_cxi=alm_cfg.min_cxi, max_sig=alm_cfg.max_sig,
        delta_sigl=alm_cfg.delta_sigl, gravity=grid.gravity,
        gnx=nx, gny=ny, gnyaw=nyaw,
        origin_x=grid.origin[0], origin_y=grid.origin[1],
        origin_yaw=grid.origin[2],
        xy_res=grid.xy_resolution, yaw_res=grid.yaw_resolution)
    S = shape.equal_num
    gdata = _host(grid.data)
    x = _host(x, (shape.num_vars,))
    hxy, txy = _host(bound.head_xy, (3, 2)), _host(bound.tail_xy, (3, 2))
    hyaw = _host(bound.head_yaw, (3, 1))
    tyaw = _host(bound.tail_yaw, (3, 1))
    lam, mu = _host(lam, (S,)), _host(mu, (shape.non_equal_num,))
    sc = _host(scale_cx, (7, S))
    return float(lib.minco_inner_cost(
        ctypes.byref(p), _dptr(gdata), _dptr(x), _dptr(hxy), _dptr(txy),
        _dptr(hyaw), _dptr(tyaw), _dptr(lam), _dptr(mu),
        ctypes.c_double(float(rho)), _dptr(sc)))


def dubins_distance(q0, q1, rho: float) -> float:
    """C++ shortest Dubins path length between SE(2) poses q0, q1."""
    lib = _load()
    q0, q1 = _host(q0, (3,)), _host(q1, (3,))
    return float(lib.dubins_distance(_dptr(q0), _dptr(q1),
                                     ctypes.c_double(rho)))
