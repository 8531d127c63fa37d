"""Binding and launch counters of the terrain-lookup CUDA kernels
(`csrc/terrain_lookup.cu`), built and loaded at first use by
`kernels/build.py`; importing this module needs no toolchain.

Every launcher checks dtype, device, shape and contiguity, raises on
anything the kernel does not take, enqueues on PyTorch's current stream and
raises if `cudaGetLastError` reports a failed launch.  Both kernels take
float32 or float64 poses (outputs in the poses' dtype): K1 over its f16
table whatever the grid's dtype, K2 over a pair table of the poses'
dtype.  It never falls back
to the plain PyTorch version: that choice is the caller's, by device
(`terrain/grid.py`).

`launches` counts kernel launches by name; only the launchers below add to
it, one per launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uneven_planner_tpu_torch.kernels.build import CudaLibrary

# every launch counts under the kernel's name; the float64 instantiations'
# launches count again under "<name>_f64"
launches = {"terrain_tv_packed16": 0, "terrain_tv_pair": 0,
            "terrain_tv_packed16_f64": 0, "terrain_tv_pair_f64": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def index_bits(table_words16: int) -> int:
    """Width of K1's and K2's index math for a table of `table_words16`
    16-byte words: 32 when every word is addressable with a 32-bit int
    (every map the planner builds: the hill's full f16 table is 10,240,000
    words, its pair table 5,120,000 in float32 and 10,240,000 in float64),
    64 otherwise."""
    return 32 if table_words16 < 2 ** 31 else 64


def words16(table: torch.Tensor) -> int:
    """16-byte words of a table: a K1 row is two, a K2 row two in float32
    and four (64 bytes) in float64."""
    return table.numel() * table.element_size() // 16


LAYOUTS = ("thread", "quad")
# threads of a block of K1 and K2 (kK1Block, kK2Block of
# csrc/terrain_lookup.cu)
_BLOCK = 128
# K2 takes a quad of lanes per sample while the quads fit in this many
# 128-thread blocks per SM (half a wave at 2,048 threads an SM)
_PAIR_QUAD_BLOCKS_PER_SM = 8


def packed16_layout(M: int, sms: int) -> str:
    """K1's layout for M lookups on a card of `sms` SMs: "thread" (a thread
    per sample) while that gives every SM a block or more, "quad" (four
    lanes per sample, which shortens one sample's chain) below.  On the
    card (`PERF.md` §6) the quad wins at the pipeline's step (M = 5,760)
    and loses from the planning step's (M = 43,520) up."""
    return "thread" if M > sms * _BLOCK else "quad"


def pair_layout(M: int, sms: int) -> str:
    """K2's layout for M lookups on a card of `sms` SMs: a quad of lanes
    per sample while the quads fit in half a wave of the card (the
    pipeline's init_scaling, M = 5,760), a thread per sample above (the
    planning path's, M = 43,520, and up).  On the card the quad wins up to
    M = 21,760 and the thread from 43,520 (`chip_studies/k2_ablation.py`,
    `PERF.md` §6)."""
    quads_fit = 4 * M <= sms * _PAIR_QUAD_BLOCKS_PER_SM * _BLOCK
    return "quad" if quads_fit else "thread"


# the dtypes the kernels take, and the suffix of their C entries
_ENTRY = {torch.float32: "", torch.float64: "_f64"}


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix, real in (("", ctypes.c_float), ("_f64", ctypes.c_double)):
        geom = [i, i, i] + [real] * 11
        k1 = getattr(lib, "terrain_tv_packed16" + suffix)
        k1.argtypes = [p] * 6 + [i] + geom + [i, i, i, i, p]
        k1.restype = i
        k2 = getattr(lib, "terrain_tv_pair" + suffix)
        k2.argtypes = [p] * 6 + [i] + geom + [i, i, i, p]
        k2.restype = i
    lib.terrain_lookup_error_string.argtypes = [i]
    lib.terrain_lookup_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("terrain_lookup", _declare)
_library = LIBRARY.load


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_poses(px, py, yaw):
    poses = (("px", px), ("py", py), ("yaw", yaw))
    for name, t in poses:
        if t.dtype not in _ENTRY or t.dtype != px.dtype:
            raise TypeError(f"{name} must be float32 or float64, as px, got "
                            f"{t.dtype}")
    for name, t in poses:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
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


def _outputs(M, want_jac, dtype, device):
    tv = torch.empty((7, M), dtype=dtype, device=device)
    jac = (torch.empty((7, 3, M), dtype=dtype, device=device)
           if want_jac else None)
    return tv, jac


def _count(name, dtype):
    launches[name] += 1
    if dtype == torch.float64:
        launches[name + "_f64"] += 1


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.terrain_lookup_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def terrain_tv_packed16(table, geom, px, py, yaw, exact: bool,
                        want_jac: bool):
    """K1: tv [7, M] (and J [7, 3, M] when `want_jac`), in the poses'
    dtype, from the f16 packed table [2*Ncells, 8] int32.  `geom` is
    `terrain.grid.kernel_geometry`.  The index width comes from the table
    size (`index_bits`) and the layout from M and the card
    (`packed16_layout`)."""
    _check_poses(px, py, yaw)
    return _launch_packed16(
        table, geom, px, py, yaw, exact, want_jac,
        layout=packed16_layout(px.numel(), _sm_count(px.device)),
        idx32=index_bits(words16(table)) == 32)


def _launch_packed16(table, geom, px, py, yaw, exact: bool, want_jac: bool,
                     *, layout: str, idx32: bool):
    """K1 in the named layout and index width (the wrapper picks both; the
    card tests name each, to hold every instantiation to the twin)."""
    _check_poses(px, py, yaw)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    nx, ny, nyaw = geom[:3]
    _check_table(table, 2 * nx * ny * nyaw, torch.int32, px.device)
    M = px.numel()
    tv, jac = _outputs(M, want_jac, px.dtype, px.device)
    if M == 0:
        return tv, jac
    lib = _library()
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = getattr(lib, "terrain_tv_packed16" + _ENTRY[px.dtype])(
        px.data_ptr(), py.data_ptr(), yaw.data_ptr(), table.data_ptr(),
        tv.data_ptr(), jac.data_ptr() if want_jac else None, M, *geom,
        int(exact), int(want_jac), int(idx32), int(layout == "quad"), stream)
    _raise_on(lib, err, "terrain_tv_packed16")
    _count("terrain_tv_packed16", px.dtype)
    return tv, jac


def terrain_tv_pair(table, geom, px, py, yaw, want_jac: bool):
    """K2: tv [7, M] (and J [7, 3, M]) from the yaw-pair table
    [Ncells, 8] of the poses' dtype (float32 or float64).  Index width and
    layout are picked as K1's (`index_bits`, `pair_layout`)."""
    _check_poses(px, py, yaw)
    return _launch_pair(
        table, geom, px, py, yaw, want_jac,
        layout=pair_layout(px.numel(), _sm_count(px.device)),
        idx32=index_bits(words16(table)) == 32)


def _launch_pair(table, geom, px, py, yaw, want_jac: bool, *, layout: str,
                 idx32: bool):
    """K2 in the named layout and index width (the card tests name each)."""
    _check_poses(px, py, yaw)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    nx, ny, nyaw = geom[:3]
    _check_table(table, nx * ny * nyaw, px.dtype, px.device)
    M = px.numel()
    tv, jac = _outputs(M, want_jac, px.dtype, px.device)
    if M == 0:
        return tv, jac
    lib = _library()
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = getattr(lib, "terrain_tv_pair" + _ENTRY[px.dtype])(
        px.data_ptr(), py.data_ptr(), yaw.data_ptr(), table.data_ptr(),
        tv.data_ptr(), jac.data_ptr() if want_jac else None, M, *geom,
        int(want_jac), int(idx32), int(layout == "quad"), stream)
    _raise_on(lib, err, "terrain_tv_pair")
    _count("terrain_tv_pair", px.dtype)
    return tv, jac
