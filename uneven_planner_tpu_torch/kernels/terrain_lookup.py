"""Binding and launch counters of the terrain-lookup CUDA kernels
(`csrc/terrain_lookup.cu`), built and loaded at first use by
`kernels/build.py`; importing this module needs no toolchain.

Every launcher checks device, dtype, shape and contiguity, raises on
anything the kernel does not take, enqueues on PyTorch's current stream and
raises if `cudaGetLastError` reports a failed launch.  It never falls back
to the plain PyTorch version: that choice is the caller's, by device
(`terrain/grid.py`).

`launches` counts kernel launches by name; only the launchers below add to
it, one per launch.
"""

from __future__ import annotations

import ctypes

import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary

launches = {"terrain_tv_packed16": 0, "terrain_tv_pair": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geom = [i, i, i] + [f] * 11
    lib.terrain_tv_packed16.argtypes = [p] * 6 + [i] + geom + [i, i, p]
    lib.terrain_tv_packed16.restype = i
    lib.terrain_tv_pair.argtypes = [p] * 6 + [i] + geom + [i, p]
    lib.terrain_tv_pair.restype = i
    lib.terrain_lookup_error_string.argtypes = [i]
    lib.terrain_lookup_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("terrain_lookup", _declare)
_library = LIBRARY.load


def _check_poses(px, py, yaw):
    for name, t in (("px", px), ("py", py), ("yaw", yaw)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous")
        if t.shape != px.shape or t.device != px.device:
            raise ValueError("px, py and yaw must share shape and device")
    if px.numel() >= 2 ** 31:
        raise ValueError("at most 2^31-1 samples per launch")


def _check_table(table, rows, dtype, device):
    if table.device != device:
        raise ValueError(f"table on {table.device}, poses on {device}")
    if table.dtype != dtype:
        raise TypeError(f"table must be {dtype}, got {table.dtype}")
    if tuple(table.shape) != (rows, 8) or not table.is_contiguous():
        raise ValueError(
            f"table must be a contiguous [{rows}, 8] tensor, got "
            f"{tuple(table.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")


def _outputs(M, want_jac, device):
    tv = torch.empty((7, M), dtype=torch.float32, device=device)
    jac = (torch.empty((7, 3, M), dtype=torch.float32, device=device)
           if want_jac else None)
    return tv, jac


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.terrain_lookup_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def terrain_tv_packed16(table, geom, px, py, yaw, exact: bool,
                        want_jac: bool):
    """K1: tv [7, M] (and J [7, 3, M] when `want_jac`) from the f16 packed
    table [2*Ncells, 8] int32.  `geom` is `terrain.grid.kernel_geometry`."""
    _check_poses(px, py, yaw)
    nx, ny, nyaw = geom[:3]
    _check_table(table, 2 * nx * ny * nyaw, torch.int32, px.device)
    M = px.numel()
    tv, jac = _outputs(M, want_jac, px.device)
    if M == 0:
        return tv, jac
    lib = _library()
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = lib.terrain_tv_packed16(
        px.data_ptr(), py.data_ptr(), yaw.data_ptr(), table.data_ptr(),
        tv.data_ptr(), jac.data_ptr() if want_jac else None, M, *geom,
        int(exact), int(want_jac), stream)
    _raise_on(lib, err, "terrain_tv_packed16")
    launches["terrain_tv_packed16"] += 1
    return tv, jac


def terrain_tv_pair(table, geom, px, py, yaw, want_jac: bool):
    """K2: tv [7, M] (and J [7, 3, M]) from the yaw-pair table
    [Ncells, 8] float32."""
    _check_poses(px, py, yaw)
    nx, ny, nyaw = geom[:3]
    _check_table(table, nx * ny * nyaw, torch.float32, px.device)
    M = px.numel()
    tv, jac = _outputs(M, want_jac, px.device)
    if M == 0:
        return tv, jac
    lib = _library()
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = lib.terrain_tv_pair(
        px.data_ptr(), py.data_ptr(), yaw.data_ptr(), table.data_ptr(),
        tv.data_ptr(), jac.data_ptr() if want_jac else None, M, *geom,
        int(want_jac), stream)
    _raise_on(lib, err, "terrain_tv_pair")
    launches["terrain_tv_pair"] += 1
    return tv, jac
