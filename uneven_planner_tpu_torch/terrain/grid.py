"""SE(2) terrain field F: SE(2) -> R x S^2_+ as dense PyTorch tensors
(port of `uneven_planner_tpu/terrain/grid.py`: the lookups of the ALM solver,
the index maps, occupancy reads and sigma lookup of the front end, and the
scalar terrain API).

The map is a dense grid over (x, y, yaw), xy clamped and yaw periodic, whose
cells hold the RXS2 value (z, sigma, zb0, zb1) (uneven_map.h:46).  The
solver reads it through two gather tables, stored row-major with 32-byte
rows so that one lookup corner is one DRAM sector on the GPU:

  data_pair      [Ncells, 8] data dtype: the row of cell (x, y, w) holds the
                 RXS2 value at yaw w and at yaw (w+1) mod Nyaw; the JAX
                 package's channel-major `data_pair`, word for word,
                 transposed and reordered with x fastest.
  data_packed16  [2*Ncells, 8] int32: words 0-5 of the row of cell
                 (x, y, w) pack {sigma, zb0, zb1} x {y, y+1} as f16 pairs
                 (value at yaw w in the high half, at w+1 in the low half);
                 rows Ncells + i hold the f16 residuals; words 6-7 are zero
                 padding.  Words 0-5 are the JAX package's `data_packed16`
                 bits, transposed and reordered with x fastest.
  data_packed    [Ncells, 12] int32, the split hi+lo bf16 table: words 0-5
                 of the row of cell (x, y, w) pack the bf16 of {sigma, zb0,
                 zb1} x {y, y+1} as pairs (yaw w high, w+1 low), words 6-11
                 the bf16 of the residuals; the JAX package's `data_packed`
                 bits, transposed and reordered with x fastest.

The tables order their cells with x fastest: cell (x, y, w) is row
(y * Nyaw + w) * Nx + x (`cell_row`) of its half, so the two x corners of a
lookup are neighbouring rows; `x_fastest` reorders a table from the JAX
package's (x, y, w) order.

The lookups of the pair and f16 tables each have a hand-written CUDA kernel
(`csrc/terrain_lookup.cu`) and a plain PyTorch twin here that computes the
same pair (tv, J): the 7 terrain variables and their local Jacobian in
(px, py, yaw), J written out analytically.  One `torch.autograd.Function`
wraps whichever runs: the twin for CPU tensors, the kernel for CUDA tensors
(or an error; never a quiet fallback).  Its backward and forward-mode
products are formed from J.  The split-bf16 lookup reads its two 48-byte
rows through the gather kernel K3 and blends them as tensor operations,
differentiated by autograd.

The front end's reads (occupancy, the bare-grid sigma corners, the RXS2 rows
of `get_terrain_batch`) are plain table reads by index; they go through the
gather kernel K3 (`kernels/gather.py:gather_rows`), with the index
arithmetic and the blends around it as tensor operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch.autograd import forward_ad as fwAD

from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
from uneven_planner_tpu_torch.kernels.gather import gather_rows

TWO_PI = 2.0 * math.pi


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s with IEEE division, as the JAX package and the CUDA kernels
    divide.  (PyTorch turns division by a Python scalar into multiplication
    by its reciprocal on the GPU, which rounds differently and can move a
    floor() to the neighbouring cell.)"""
    return a / a.new_full((), s)


def normalize_so2(yaw: torch.Tensor) -> torch.Tensor:
    """Branchless UnevenMap::normSO2 (uneven_map.cpp:64-71): wrap into
    [-pi, pi).  Derivative 1 (floor has derivative 0)."""
    return yaw - TWO_PI * torch.floor(_div(yaw + math.pi, TWO_PI))


def so2_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed angular difference a-b wrapped into (-pi, pi]
    (uneven_map.h:179)."""
    return torch.atan2(torch.sin(a - b), torch.cos(a - b))


@dataclasses.dataclass(frozen=True, eq=False)
class TerrainGrid:
    """Dense RXS2 field, derived occupancy, optional gather tables and static
    geometry.

    data:    [Nx, Ny, Nyaw, 4] channels (z, sigma, zb0, zb1)
    occ:     [Nx, Ny, Nyaw] bool (uneven_map.cpp:170-179)
    occ_xy:  [Nx, Ny] bool, any yaw occupied
    """

    data: torch.Tensor
    occ: torch.Tensor
    occ_xy: torch.Tensor
    data_pair: torch.Tensor | None = None
    data_packed16: torch.Tensor | None = None
    data_packed: torch.Tensor | None = None
    xy_resolution: float = 0.05
    yaw_resolution: float = 0.1
    origin: Tuple[float, float, float] = (-5.0, -5.0, -(math.pi + 2.5e-2))
    gravity: float = 9.81

    @property
    def voxel_num(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape[:3])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def map_size(self) -> Tuple[float, float, float]:
        n = self.voxel_num
        return (n[0] * self.xy_resolution, n[1] * self.xy_resolution,
                n[2] * self.yaw_resolution)

    @property
    def min_boundary(self) -> Tuple[float, float, float]:
        return self.origin

    @property
    def max_boundary(self) -> Tuple[float, float, float]:
        o, m = self.origin, self.map_size
        return (o[0] + m[0], o[1] + m[1], o[2] + m[2])

    def replace(self, **changes) -> "TerrainGrid":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TerrainGrid":
        """The same grid, every tensor (tables included) on `device`."""
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def from_buffers(data: torch.Tensor, min_cnormal: float, max_rho: float,
                 xy_resolution: float, yaw_resolution: float,
                 origin: Tuple[float, float, float],
                 gravity: float = 9.81) -> TerrainGrid:
    """TerrainGrid from the raw RXS2 buffer, deriving occupancy
    (uneven_map.cpp:170-179)."""
    zb = data[..., 2:4]
    c = torch.sqrt(torch.clamp(1.0 - torch.sum(zb * zb, dim=-1), min=0.0))
    occ = (c < min_cnormal) | (data[..., 1] > max_rho)
    return TerrainGrid(data=data, occ=occ, occ_xy=occ.any(dim=-1),
                       xy_resolution=xy_resolution,
                       yaw_resolution=yaw_resolution,
                       origin=tuple(origin), gravity=gravity)


# ---------------------------------------------------------------------------
# Gather tables
# ---------------------------------------------------------------------------

def with_pair_table(grid: TerrainGrid) -> TerrainGrid:
    """Attach the yaw-pair table [Ncells, 8]: (z, sigma, zb0, zb1) at yaw w,
    then at (w+1) mod Nyaw (grid.py:453-458, row-major, cells x fastest)."""
    nx, ny, nyaw = grid.voxel_num
    pair = torch.cat([grid.data, torch.roll(grid.data, -1, dims=2)], dim=-1)
    return grid.replace(data_pair=x_fastest(
        pair.reshape(nx * ny * nyaw, 8), grid.voxel_num))


def _f16_bits(h: torch.Tensor) -> torch.Tensor:
    """float16 tensor -> its 16 bits as non-negative int32."""
    return h.view(torch.int16).to(torch.int32) & 0xFFFF


def with_packed_f16(grid: TerrainGrid) -> TerrainGrid:
    """Attach the f16 hi + f16-residual packed (y, yaw)-pair table
    [2*Ncells, 8] int32 (grid.py:508-545, row-major, padded to 8 words):
      word[2*ch + yy] = f16(v[ch, y+yy, w]) << 16 | f16(v[ch, y+yy, w+1])
    for ch in (sigma, zb0, zb1), yy in (0, 1); y+1 clipped, w+1 wrapped.
    Rows Ncells + i hold f16(v - f32(f16(v)))."""
    nx, ny, nyaw = grid.voxel_num
    ncells = nx * ny * nyaw
    d = grid.data[..., 1:4].to(torch.float32)
    dw1 = torch.roll(d, -1, dims=2)
    ynext = torch.clamp(torch.arange(ny, device=d.device) + 1, max=ny - 1)
    dy1 = d[:, ynext]
    dy1w1 = torch.roll(dy1, -1, dims=2)
    corners = (d, dw1, dy1, dy1w1)
    his = [a.to(torch.float16) for a in corners]
    los = [(a - h.to(torch.float32)).to(torch.float16)
           for a, h in zip(corners, his)]

    def words(part):
        out = []
        for ch in range(3):
            for yy in range(2):
                w0 = _f16_bits(part[2 * yy][..., ch])
                w1 = _f16_bits(part[2 * yy + 1][..., ch])
                out.append((w0 << 16) | w1)
        return torch.stack(out, dim=-1).reshape(ncells, 6)

    packed = torch.zeros((2 * ncells, 8), dtype=torch.int32, device=d.device)
    packed[:ncells, :6] = words(his)
    packed[ncells:, :6] = words(los)
    return grid.replace(data_packed16=x_fastest(packed, grid.voxel_num))


def _bf16_round_bits(u32: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even float32 bit patterns (int64 holding the 32
    unsigned bits) -> the upper-16 bf16 bits (grid.py:461-466)."""
    return (u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16


def _f32_bits(a: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> its 32 bits as a non-negative int64."""
    return a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def with_packed_table(grid: TerrainGrid) -> TerrainGrid:
    """Attach the split hi+lo bf16 (y, yaw)-pair table [Ncells, 12] int32
    (grid.py:469-505, row-major, cells x fastest):
      word[2*ch + yy]     = hi(v[ch, y+yy, w]) << 16 | hi(v[ch, y+yy, w+1])
      word[6 + 2*ch + yy] = lo(v[ch, y+yy, w]) << 16 | lo(v[ch, y+yy, w+1])
    for ch in (sigma, zb0, zb1), yy in (0, 1); y+1 clipped, w+1 wrapped.
    hi is the RNE bf16 of the float32 value, lo the RNE bf16 of the
    residual, so hi + lo is the value within ~4e-6 relative."""
    nx, ny, nyaw = grid.voxel_num
    d = grid.data[..., 1:4].to(torch.float32)
    dw1 = torch.roll(d, -1, dims=2)
    ynext = torch.clamp(torch.arange(ny, device=d.device) + 1, max=ny - 1)
    dy1 = d[:, ynext]
    dy1w1 = torch.roll(dy1, -1, dims=2)
    corners = (d, dw1, dy1, dy1w1)
    hi_bits = [_bf16_round_bits(_f32_bits(a)) for a in corners]
    hi_vals = [((b << 16) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
               for b in hi_bits]
    lo_bits = [_bf16_round_bits(_f32_bits(a - hv))
               for a, hv in zip(corners, hi_vals)]
    words = []
    for part in (hi_bits, lo_bits):
        for ch in range(3):
            for yy in range(2):
                w0, w1 = part[2 * yy][..., ch], part[2 * yy + 1][..., ch]
                words.append(((w0 << 16) & 0xFFFFFFFF) | w1)
    packed = torch.stack(words, dim=-1).reshape(nx * ny * nyaw, 12)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    return grid.replace(data_packed=x_fastest(packed.to(torch.int32),
                                              grid.voxel_num))


def x_fastest(rows, voxel_num):
    """Rows of a table [h*Ncells, k] (tensor or numpy array; h halves of
    Ncells rows each, h = 2 for the packed table's hi and residual
    halves) in cell order (x, y, w), reordered with x fastest: the cell
    (x, y, w) moves to row `cell_row(x, y, w)` of its half."""
    nx, ny, nyaw = voxel_num
    k = rows.shape[-1]
    split = rows.reshape(-1, nx, ny, nyaw, k)
    if isinstance(rows, torch.Tensor):
        return split.permute(0, 2, 3, 1, 4).reshape(-1, k).contiguous()
    return split.transpose(0, 2, 3, 1, 4).reshape(-1, k).copy()


def cell_row(ix, iy, iw, voxel_num):
    """Row of cell (ix, iy, iw) in `data_pair` and in the hi half of
    `data_packed16`."""
    nx, ny, nyaw = voxel_num
    return (iy * nyaw + iw) * nx + ix


def _u16_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Non-negative int32 holding 16 f16 bits -> float32 value."""
    signed = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def _unpack_f16_pair(words: torch.Tensor):
    """int32 words -> (value at yaw w, value at yaw w+1) in float32
    (grid.py:548-554)."""
    return _u16_to_f32((words >> 16) & 0xFFFF), _u16_to_f32(words & 0xFFFF)


def _u16_bf16_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Non-negative int32 holding 16 bf16 bits -> float32 value (exact)."""
    signed = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return signed.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def _unpack_bf16_pair(words: torch.Tensor):
    """int32 words -> (high half, low half) as float32 values: the values
    at yaw w and at w+1 (grid.py:611-618)."""
    return (_u16_bf16_to_f32((words >> 16) & 0xFFFF),
            _u16_bf16_to_f32(words & 0xFFFF))


def kernel_geometry(grid: TerrainGrid) -> tuple:
    """Static geometry in the order the CUDA launchers take it: (nx, ny,
    nyaw, res, yres, ox, oy, oyaw, 0.5*res, 0.5*yres, lo_x, hi_x, lo_y,
    hi_y), the in-map thresholds with their 1e-4 margins folded in exactly
    as the plain version writes them."""
    nx, ny, nyaw = grid.voxel_num
    res, yres = grid.xy_resolution, grid.yaw_resolution
    ox, oy, oyaw = grid.origin
    return (nx, ny, nyaw, res, yres, ox, oy, oyaw, 0.5 * res, 0.5 * yres,
            ox + 1e-4, ox + nx * res - 1e-4, oy + 1e-4, oy + ny * res - 1e-4)


# ---------------------------------------------------------------------------
# Plain PyTorch twins of the kernels: (tv [7, M], J [7, 3, M] or None)
# ---------------------------------------------------------------------------

def _to_index(f: torch.Tensor) -> torch.Tensor:
    """Floored float -> int64 as the CUDA kernels convert (NaN -> 0,
    saturating), so both pick the same rows whatever the pose."""
    f = torch.nan_to_num(f, nan=0.0, posinf=2.0 ** 31, neginf=-2.0 ** 31)
    return f.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def _to_index32(f: torch.Tensor) -> torch.Tensor:
    """Floored float -> int32 (as the JAX package's index maps), for cell
    indices that are bounded into a table right after: NaN -> 0, saturating
    at +-2^30 so that a neighbour's `+ 1` cannot overflow."""
    f = torch.nan_to_num(f, nan=0.0, posinf=2.0 ** 30, neginf=-2.0 ** 30)
    return f.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int32)


def _cell(grid: TerrainGrid, px, py, yaw, low_y_rule: bool,
          to_index=_to_index):
    """Index math of grid.py:571-583 (packed, with the low-y rule) and
    grid.py:803-815 (pair)."""
    nx, ny, nyaw = grid.voxel_num
    res, yres = grid.xy_resolution, grid.yaw_resolution
    ox, oy, oyaw = grid.origin
    ixf = torch.floor(_div(px - 0.5 * res - ox, res))
    iyf = torch.floor(_div(py - 0.5 * res - oy, res))
    ywm = normalize_so2(yaw - 0.5 * yres)
    iwf = torch.floor(_div(ywm - oyaw, yres))
    wx = _div(px - ((ixf + 0.5) * res + ox), res)
    wy = _div(py - ((iyf + 0.5) * res + oy), res)
    low = (iyf < 0) if low_y_rule else torch.zeros_like(px, dtype=torch.bool)
    wy = torch.where(low, 0.0, wy)
    wt = _div(so2_diff(yaw, (iwf + 0.5) * yres + oyaw), yres)
    ix, iy, iw = to_index(ixf), to_index(iyf), to_index(iwf)
    inside = (px > ox + 1e-4) & (px < ox + nx * res - 1e-4) \
        & (py > oy + 1e-4) & (py < oy + ny * res - 1e-4)
    return dict(wx=wx, wy=wy, wt=wt, low=low, inside=inside,
                ix0=ix.clamp(0, nx - 1), ix1=(ix + 1).clamp(0, nx - 1),
                iy0=iy.clamp(0, ny - 1), iy1=(iy + 1).clamp(0, ny - 1),
                iw=torch.remainder(iw, nyaw))


def _tv_from_fields(sig, zb0, zb1, yaw) -> torch.Tensor:
    """7-tuple terrain variables from interpolated (sigma, zb0, zb1) and yaw
    (grid.py:700-712, uneven_map.h:221-256)."""
    c = torch.sqrt(torch.clamp(1.0 - zb0 * zb0 - zb1 * zb1, min=1e-12))
    inv_c = 1.0 / c
    cyaw, syaw = torch.cos(yaw), torch.sin(yaw)
    t = cyaw * zb0 + syaw * zb1
    s = syaw * zb0 - cyaw * zb1
    sqrt_1_t2 = torch.sqrt(torch.clamp(1.0 - t * t, min=1e-12))
    inv_sq = 1.0 / sqrt_1_t2
    return torch.stack([inv_sq, -c * t * inv_sq, sqrt_1_t2 * inv_c,
                        s * inv_sq, c, inv_c, sig])


def _tv_jac_from_fields(sig, zb0, zb1, yaw, dsig, dzb0, dzb1):
    """Jacobian [7, 3, M] of `_tv_from_fields` along (px, py, yaw), given the
    field derivatives d* [M, 3]; yaw also enters directly through cos/sin.
    Floors pass no gradient where active, as jnp.maximum's does."""
    q = 1.0 - zb0 * zb0 - zb1 * zb1
    c = torch.sqrt(torch.clamp(q, min=1e-12))
    inv_c = 1.0 / c
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    t = cy * zb0 + sy * zb1
    s = sy * zb0 - cy * zb1
    p = 1.0 - t * t
    sq = torch.sqrt(torch.clamp(p, min=1e-12))
    inv_sq = 1.0 / sq
    zero = torch.zeros_like(s)
    col = lambda a: a[:, None]
    dc = torch.where(col(q > 1e-12),
                     -(col(zb0) * dzb0 + col(zb1) * dzb1) / col(c), 0.0)
    dt = col(cy) * dzb0 + col(sy) * dzb1 + torch.stack([zero, zero, -s], 1)
    ds = col(sy) * dzb0 - col(cy) * dzb1 + torch.stack([zero, zero, t], 1)
    dsq = torch.where(col(p > 1e-12), -col(t) * dt / col(sq), 0.0)
    dinv_sq = -col(inv_sq) * col(inv_sq) * dsq
    dinv_c = -col(inv_c) * col(inv_c) * dc
    c_, t_, s_ = col(c), col(t), col(s)
    J = torch.stack([
        dinv_sq,
        -(dc * t_ * col(inv_sq) + c_ * dt * col(inv_sq) + c_ * t_ * dinv_sq),
        dsq * col(inv_c) + col(sq) * dinv_c,
        ds * col(inv_sq) + s_ * dinv_sq,
        dc,
        dinv_c,
        dsig,
    ])                                                  # [7, M, 3]
    return J.permute(0, 2, 1).contiguous()


def _tail(val, D, yaw, inside, want_jac):
    """Mask, then the shared 7-tuple tail.  val [M, 3] fields, D [M, 3ch,
    3coord] their derivatives."""
    val = torch.where(inside[:, None], val, 0.0)
    tv = _tv_from_fields(val[:, 0], val[:, 1], val[:, 2], yaw)
    if not want_jac:
        return tv, None
    D = torch.where(inside[:, None, None], D, 0.0)
    return tv, _tv_jac_from_fields(val[:, 0], val[:, 1], val[:, 2], yaw,
                                   D[:, 0], D[:, 1], D[:, 2])


def packed16_tv_jac(grid: TerrainGrid, px, py, yaw, exact: bool,
                    want_jac: bool):
    """Plain twin of kernel K1 (get_terrain_variables_cm_packed16,
    grid.py:557-608): 2 rows of the f16 table per lookup, 4 in exact mode
    (hi + residual)."""
    nx, ny, nyaw = grid.voxel_num
    ncells = nx * ny * nyaw
    res, yres = grid.xy_resolution, grid.yaw_resolution
    k = _cell(grid, px, py, yaw, low_y_rule=True)
    M = px.shape[0]
    rows = torch.stack([
        cell_row(k["ix0"], k["iy0"], k["iw"], grid.voxel_num),
        cell_row(k["ix1"], k["iy0"], k["iw"], grid.voxel_num)], 1)

    def gather(r):                                      # -> 2 x [M, 2, 6]
        r = r.reshape(-1).clamp(0, 2 * ncells - 1)
        words = grid.data_packed16.index_select(0, r)[:, :6]
        return _unpack_f16_pair(words.reshape(M, 2, 6))

    v0, v1 = gather(rows)
    if exact:
        r0, r1 = gather(rows + ncells)
        v0, v1 = v0 + r0, v1 + r1
    v0, v1 = v0.to(px.dtype), v1.to(px.dtype)
    wx, wy, wt = (k[n][:, None] for n in ("wx", "wy", "wt"))
    vw = v0 * (1.0 - wt[..., None]) + v1 * wt[..., None]   # [M, 2x, 6]
    vy = vw[..., 0::2] * (1.0 - wy[..., None]) + vw[..., 1::2] * wy[..., None]
    val = vy[:, 0] * (1.0 - wx) + vy[:, 1] * wx             # [M, 3]
    if not want_jac:
        return _tail(val, None, yaw, k["inside"], False)
    dx = _div(vy[:, 1] - vy[:, 0], res)
    gy = vw[..., 1::2] - vw[..., 0::2]
    dy = torch.where(k["low"][:, None], 0.0,
                     _div(gy[:, 0] * (1.0 - wx) + gy[:, 1] * wx, res))
    dv = v1 - v0
    e = dv[..., 0::2] * (1.0 - wy[..., None]) + dv[..., 1::2] * wy[..., None]
    dw = _div(e[:, 0] * (1.0 - wx) + e[:, 1] * wx, yres)
    return _tail(val, torch.stack([dx, dy, dw], -1), yaw, k["inside"], True)


def pair_tv_jac(grid: TerrainGrid, px, py, yaw, want_jac: bool):
    """Plain twin of kernel K2 (the exact path of get_terrain_variables_cm,
    grid.py:797-843): 4 rows of the pair table per lookup."""
    nx, ny, nyaw = grid.voxel_num
    res, yres = grid.xy_resolution, grid.yaw_resolution
    k = _cell(grid, px, py, yaw, low_y_rule=False)
    M = px.shape[0]
    x0, x1, y0, y1, w = k["ix0"], k["ix1"], k["iy0"], k["iy1"], k["iw"]
    row = lambda x, y: cell_row(x, y, w, grid.voxel_num)
    rows = torch.stack([row(x0, y0), row(x0, y1), row(x1, y0), row(x1, y1)],
                       1).reshape(-1).clamp(0, nx * ny * nyaw - 1)
    v = grid.data_pair.index_select(0, rows).reshape(M, 4, 8).to(px.dtype)
    a, b = v[..., 1:4], v[..., 5:8]                  # (sig, zb0, zb1) at w, w+1
    wx, wy, wt = k["wx"], k["wy"], k["wt"]
    vy = a * (1.0 - wt)[:, None, None] + b * wt[:, None, None]  # [M, 4, 3]

    def corners(f, wts):                             # sum_c f[:, c] * wts[c]
        return (f[:, 0] * wts[0][:, None] + f[:, 1] * wts[1][:, None]
                + f[:, 2] * wts[2][:, None] + f[:, 3] * wts[3][:, None])

    wxy = ((1.0 - wx) * (1.0 - wy), (1.0 - wx) * wy, wx * (1.0 - wy), wx * wy)
    val = corners(vy, wxy)
    if not want_jac:
        return _tail(val, None, yaw, k["inside"], False)
    dx = _div(corners(vy, (-(1.0 - wy), -wy, 1.0 - wy, wy)), res)
    dy = _div(corners(vy, (-(1.0 - wx), 1.0 - wx, -wx, wx)), res)
    dw = _div(corners(b - a, wxy), yres)
    return _tail(val, torch.stack([dx, dy, dw], -1), yaw, k["inside"], True)


# ---------------------------------------------------------------------------
# Autograd around whichever of kernel / twin runs
# ---------------------------------------------------------------------------

class _TerrainTV(torch.autograd.Function):
    """tv = f(px, py, yaw) with the local Jacobian J from the same call;
    backward is sum_k gtv_k J_k, forward mode is J t."""

    @staticmethod
    def forward(px, py, yaw, run):
        return run(px, py, yaw, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        jac = output[1]
        ctx.mark_non_differentiable(jac)
        ctx.save_for_backward(jac)
        ctx.save_for_forward(jac)

    @staticmethod
    def backward(ctx, gtv, _gjac):
        jac, = ctx.saved_tensors
        g = (gtv[:, None, :] * jac).sum(0)
        return g[0], g[1], g[2], None

    @staticmethod
    def jvp(ctx, tpx, tpy, tyaw, _run):
        jac, = ctx.saved_tensors
        tan = torch.stack([torch.zeros_like(jac[0, 0]) if t is None else t
                           for t in (tpx, tpy, tyaw)])
        return (jac * tan[None]).sum(1), None


def _runner(grid: TerrainGrid, kind: str, exact: bool):
    """(px, py, yaw, want_jac) -> (tv, J): the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors, an error otherwise."""
    def run(px, py, yaw, want_jac):
        if px.device.type == "cuda":
            geom = kernel_geometry(grid)
            if kind == "packed16":
                return kernels.terrain_tv_packed16(
                    grid.data_packed16, geom, px, py, yaw, exact, want_jac)
            return kernels.terrain_tv_pair(grid.data_pair, geom, px, py, yaw,
                                           want_jac)
        if px.device.type == "cpu":
            if kind == "packed16":
                return packed16_tv_jac(grid, px, py, yaw, exact, want_jac)
            return pair_tv_jac(grid, px, py, yaw, want_jac)
        raise ValueError(f"no terrain lookup for device {px.device}")
    return run


def _has_tangent(t: torch.Tensor) -> bool:
    return fwAD.unpack_dual(t).tangent is not None


def _terrain_tv(run, px, py, yaw) -> torch.Tensor:
    shape = px.shape
    px, py, yaw = (t.reshape(-1).contiguous() for t in (px, py, yaw))
    ins = (px, py, yaw)
    if (torch.is_grad_enabled() and any(t.requires_grad for t in ins)) \
            or any(_has_tangent(t) for t in ins):
        tv = _TerrainTV.apply(px, py, yaw, run)[0]
    else:
        tv = run(px, py, yaw, False)[0]
    return tv.reshape((7,) + tuple(shape))


def get_terrain_variables_cm_packed16(grid: TerrainGrid, px, py, yaw,
                                      exact: bool = False) -> torch.Tensor:
    """Channel-major terrain variables [7, ...] via the f16 packed table
    (yaw pre-normalized into [-pi, pi)).  exact=False reads the 2 hi rows
    (field error <= ~2.5e-4 relative), exact=True adds the 2 residual rows
    (<= ~2e-7)."""
    if grid.data_packed16 is None:
        raise ValueError("grid has no f16 packed table (with_packed_f16)")
    return _terrain_tv(_runner(grid, "packed16", exact), px, py, yaw)


def get_terrain_variables_cm_packed(grid: TerrainGrid, px, py,
                                    yaw) -> torch.Tensor:
    """Channel-major terrain variables [7, ...] via the split hi+lo bf16
    table (grid.py:715-768; yaw pre-normalized into [-pi, pi)): the two
    x-corner rows of 12 words through K3, then hi + lo, the yaw, y and x
    blends and the 7-tuple tail as tensor operations, differentiable in px,
    py and yaw by autograd.  Within ~4e-6 relative of the exact path on the
    stored field."""
    if grid.data_packed is None:
        raise ValueError("grid has no split-bf16 table (with_packed_table)")
    shape = px.shape
    px, py, yaw = (t.reshape(-1) for t in (px, py, yaw))
    M = px.shape[0]
    # low-y edge: the pair at row 0 is (0, 1) where the exact path clamps
    # both y corners to row 0, so the blend weight is zeroed (`_cell`)
    k = _cell(grid, px, py, yaw, low_y_rule=True, to_index=_to_index32)
    rows = torch.stack([cell_row(k["ix0"], k["iy0"], k["iw"], grid.voxel_num),
                        cell_row(k["ix1"], k["iy0"], k["iw"],
                                 grid.voxel_num)])           # [2x, M]
    words = gather_rows(grid.data_packed, rows.reshape(-1)).reshape(2, M, 12)
    v_w0, v_w1 = _unpack_bf16_pair(words)                   # at w, w+1
    # hi + lo residual, in float32 as the table's values
    v_w0 = (v_w0[..., :6] + v_w0[..., 6:]).to(px.dtype)     # [2x, M, 6]
    v_w1 = (v_w1[..., :6] + v_w1[..., 6:]).to(px.dtype)
    wx, wy, wt = (k[n][:, None] for n in ("wx", "wy", "wt"))
    vw = v_w0 * (1.0 - wt) + v_w1 * wt                      # yaw blend
    # columns [2*ch + yy]: the y blend, then the x blend
    vy = vw[..., 0::2] * (1.0 - wy) + vw[..., 1::2] * wy    # [2x, M, 3]
    val = vy[0] * (1.0 - wx) + vy[1] * wx                   # [M, 3]
    val = torch.where(k["inside"][:, None], val, 0.0)
    tv = _tv_from_fields(val[:, 0], val[:, 1], val[:, 2], yaw)
    return tv.reshape((7,) + tuple(shape))


def get_terrain_variables_cm(grid: TerrainGrid, px, py, yaw,
                             exact: bool = True) -> torch.Tensor:
    """Channel-major batched terrain variables [7, ...] from coordinate
    tensors of one shape (yaw pre-normalized into [-pi, pi)).

    exact=False takes the cheapest fast table attached (grid.py:787-790):
    the f16 table's 2-row path, else the split-bf16 table's; otherwise the
    exact 4-row pair-table path, and on a bare grid (no table)
    `get_terrain_variables_batch`, the 8 corner rows through K3,
    differentiable in px, py and yaw by autograd."""
    if not exact and grid.data_packed16 is not None:
        return get_terrain_variables_cm_packed16(grid, px, py, yaw)
    if not exact and grid.data_packed is not None:
        return get_terrain_variables_cm_packed(grid, px, py, yaw)
    if grid.data_pair is None:                  # a bare grid (grid.py:791-793)
        poses = torch.stack([px, py, yaw], dim=-1).reshape(-1, 3)
        return get_terrain_variables_batch(grid, poses).T.reshape(
            (7,) + tuple(px.shape))
    return _terrain_tv(_runner(grid, "pair", True), px, py, yaw)


# ---------------------------------------------------------------------------
# Index math and occupancy (uneven_map.h:398-435, 490-500); batched over the
# leading dimensions of `pos`
# ---------------------------------------------------------------------------

def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def pos_to_index(grid: TerrainGrid, pos: torch.Tensor) -> torch.Tensor:
    """[..., 3] SE(2) positions -> [..., 3] int64 cell indices (unbounded)."""
    res_inv = _vec([1.0 / grid.xy_resolution, 1.0 / grid.xy_resolution,
                    1.0 / grid.yaw_resolution], pos)
    return _to_index(torch.floor((pos - _vec(grid.origin, pos)) * res_inv))


def index_to_pos(grid: TerrainGrid, idx: torch.Tensor,
                 dtype=torch.float64) -> torch.Tensor:
    res = torch.tensor([grid.xy_resolution, grid.xy_resolution,
                        grid.yaw_resolution], dtype=dtype, device=idx.device)
    o = torch.tensor(grid.origin, dtype=dtype, device=idx.device)
    return (idx.to(dtype) + 0.5) * res + o


def bound_index(grid: TerrainGrid, idx: torch.Tensor) -> torch.Tensor:
    """Clamp xy, wrap yaw (uneven_map.h:398-409)."""
    n = grid.voxel_num
    return torch.stack([idx[..., 0].clamp(0, n[0] - 1),
                        idx[..., 1].clamp(0, n[1] - 1),
                        torch.remainder(idx[..., 2], n[2])], dim=-1)


def is_in_map(grid: TerrainGrid, pos: torch.Tensor) -> torch.Tensor:
    """Strictly inside the map with 1e-4 margins, over the last dimension
    of `pos` ([..., 2] or [..., 3])."""
    d = pos.shape[-1]
    lo = _vec(grid.min_boundary[:d], pos)
    hi = _vec(grid.max_boundary[:d], pos)
    return (pos > lo + 1e-4).all(-1) & (pos < hi - 1e-4).all(-1)


def _read(table: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """table.reshape(-1)[lin] for an index tensor of any shape, through K3.
    The callers pass int32 linear indices (every table here has fewer than
    2^31 cells), which halves the index bytes K3 reads."""
    return gather_rows(table.reshape(-1), lin.reshape(-1)).reshape(lin.shape)


def is_occupancy(grid: TerrainGrid, pos: torch.Tensor) -> torch.Tensor:
    """SE(2) occupancy of [..., 3] positions; out-of-map counts as occupied
    (the safe planning semantics of the JAX package)."""
    nx, ny, nyaw = grid.voxel_num
    idx = bound_index(grid, pos_to_index(grid, pos))
    lin = ((idx[..., 0] * ny + idx[..., 1]) * nyaw + idx[..., 2]) \
        .to(torch.int32)
    return _read(grid.occ, lin) | ~is_in_map(grid, pos)


def is_occupancy_xy_batch(grid: TerrainGrid, px: torch.Tensor,
                          py: torch.Tensor) -> torch.Tensor:
    """2D occupancy from coordinate tensors of one shape
    (uneven_map.h:490-500); out of the map counts as occupied."""
    nx, ny, _ = grid.voxel_num
    ox, oy, _ = grid.origin
    ix = _to_index32(torch.floor(_div(px - ox, grid.xy_resolution)))
    iy = _to_index32(torch.floor(_div(py - oy, grid.xy_resolution)))
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    lin = ix.clamp(0, nx - 1) * ny + iy.clamp(0, ny - 1)
    return _read(grid.occ_xy, lin) | ~inside


def is_occupancy_xy(grid: TerrainGrid, pos_xy: torch.Tensor) -> torch.Tensor:
    """2D occupancy from [..., 2 or more] positions (x, y, ...)."""
    return is_occupancy_xy_batch(grid, pos_xy[..., 0], pos_xy[..., 1])


# ---------------------------------------------------------------------------
# Front-end and metric lookups
# ---------------------------------------------------------------------------

def terrain_sigma_cm(grid: TerrainGrid, px, py, yaw) -> torch.Tensor:
    """Interpolated sigma at coordinate tensors of one shape (yaw normalized
    into [-pi, pi)): the flatness term of the front end's g-score
    (kino_astar.cpp:187-195).  Reads the f16 table when attached (kernel
    K1), else the split-bf16 table (K3), else the pair table (K2), else
    the 8 corners of the bare grid (K3)."""
    if grid.data_packed16 is not None:
        return get_terrain_variables_cm_packed16(grid, px, py, yaw)[6]
    if grid.data_packed is not None:
        return get_terrain_variables_cm_packed(grid, px, py, yaw)[6]
    if grid.data_pair is not None:
        return get_terrain_variables_cm(grid, px, py, yaw)[6]
    nyaw = grid.voxel_num[2]
    ny = grid.voxel_num[1]
    k = _cell(grid, px, py, yaw, low_y_rule=False, to_index=_to_index32)
    iw0, iw1 = k["iw"], torch.remainder(k["iw"] + 1, nyaw)
    idx8 = torch.stack([(x * ny + y) * nyaw + w
                        for x in (k["ix0"], k["ix1"])
                        for y in (k["iy0"], k["iy1"])
                        for w in (iw0, iw1)])               # [8, ...]
    v = _read(grid.data[..., 1], idx8)
    wx, wy, wt = k["wx"], k["wy"], k["wt"]
    vt = v[0::2] * (1.0 - wt) + v[1::2] * wt         # (x0y0, x0y1, x1y0, x1y1)
    vy = vt[0::2] * (1.0 - wy) + vt[1::2] * wy       # (x0, x1)
    val = vy[0] * (1.0 - wx) + vy[1] * wx
    return torch.where(k["inside"], val, 0.0)


def _corners(grid: TerrainGrid, poses: torch.Tensor):
    """The 8 corner rows v [M, 2(x), 2(y), 2(yaw), 4] of [M, 3] SE(2) poses,
    read through K3 with clamped xy and wrapped yaw, and the fractional
    offsets diff [M, 3] (grid.py:620-640)."""
    nx, ny, nyaw = grid.voxel_num
    half = _vec([0.5 * grid.xy_resolution, 0.5 * grid.xy_resolution,
                 0.5 * grid.yaw_resolution], poses)
    o = _vec(grid.origin, poses)
    res_inv = _vec([1.0 / grid.xy_resolution, 1.0 / grid.xy_resolution,
                    1.0 / grid.yaw_resolution], poses)
    pos_m = poses - half
    pos_m = torch.cat([pos_m[:, :2], normalize_so2(pos_m[:, 2:])], dim=1)
    idxf = torch.floor((pos_m - o) * res_inv)
    idx_pos = (idxf + 0.5) / res_inv + o
    diff = torch.stack([
        (poses[:, 0] - idx_pos[:, 0]) * res_inv[0],
        (poses[:, 1] - idx_pos[:, 1]) * res_inv[1],
        so2_diff(poses[:, 2], idx_pos[:, 2]) * res_inv[2]], dim=1)
    idx = _to_index32(idxf)
    M = poses.shape[0]
    two = torch.arange(2, device=poses.device, dtype=torch.int32)
    ix = (idx[:, 0, None] + two).clamp(0, nx - 1)               # [M, 2]
    iy = (idx[:, 1, None] + two).clamp(0, ny - 1)
    iw = torch.remainder(idx[:, 2, None] + two, nyaw)
    flat = ((ix[:, :, None, None] * ny + iy[:, None, :, None]) * nyaw
            + iw[:, None, None, :])                             # [M, 2, 2, 2]
    v = gather_rows(grid.data.reshape(-1, 4), flat.reshape(-1)) \
        .reshape(M, 2, 2, 2, 4)
    return v, diff


def get_terrain_batch(grid: TerrainGrid, poses: torch.Tensor) -> torch.Tensor:
    """[M, 4] RXS2 values (z, sigma, zb0, zb1) at [M, 3] SE(2) poses:
    trilinear interpolation over the 8 corner rows of the dense grid
    (uneven_map.h:154-201); out-of-map poses read zeros."""
    v, diff = _corners(grid, poses)
    w0 = diff[:, 0].reshape(-1, 1, 1, 1)
    w1 = diff[:, 1].reshape(-1, 1, 1)
    w2 = diff[:, 2].reshape(-1, 1)
    vx = v[:, 0] * (1 - w0) + v[:, 1] * w0
    vy = vx[:, 0] * (1 - w1) + vx[:, 1] * w1
    val = vy[:, 0] * (1 - w2) + vy[:, 1] * w2
    return torch.where(is_in_map(grid, poses)[:, None], val, 0.0)


def get_terrain_variables_batch(grid: TerrainGrid,
                                poses: torch.Tensor) -> torch.Tensor:
    """[M, 7] terrain variables at [M, 3] SE(2) poses from the dense grid
    (no table needed): the post-solve metrics' lookup."""
    value = get_terrain_batch(grid, poses)
    return _tv_from_fields(value[:, 1], value[:, 2], value[:, 3],
                           poses[:, 2]).T


# ---------------------------------------------------------------------------
# The scalar terrain API (grid.py:190-365), batched over the leading
# dimensions of `pos` [..., 3]
# ---------------------------------------------------------------------------

def _batched(fn, pos: torch.Tensor, *outs):
    """fn([M, 3] poses) -> tensors [M, *out]; reshaped to [..., *out]."""
    lead = tuple(pos.shape[:-1])
    res = fn(pos.reshape(-1, 3))
    if isinstance(res, torch.Tensor):
        return res.reshape(lead + outs[0])
    return tuple(r.reshape(lead + o) for r, o in zip(res, outs))


def get_terrain(grid: TerrainGrid, pos: torch.Tensor) -> torch.Tensor:
    """[..., 4] interpolated RXS2 value (z, sigma, zb0, zb1) at [..., 3]
    SE(2) poses; out-of-map poses read zeros (uneven_map.h:154-201)."""
    return _batched(lambda p: get_terrain_batch(grid, p), pos, (4,))


def get_c(value: torch.Tensor) -> torch.Tensor:
    """Normal z-component c = sqrt(1 - |zb|^2) of RXS2 values [..., 4]
    (uneven_map.h:46)."""
    zb = value[..., 2:4]
    return torch.sqrt(torch.clamp(1.0 - torch.sum(zb * zb, dim=-1),
                                  min=1e-12))


def _with_grad(grid: TerrainGrid, poses: torch.Tensor):
    """[M, 4] values and [M, 4, 3] analytic gradients (grid.py:239-273)."""
    v, w = _corners(grid, poses)                  # [M, 2x, 2y, 2yaw, 4]
    w1, w2 = w[:, 1].reshape(-1, 1), w[:, 2].reshape(-1, 1)
    w0 = w[:, 0].reshape(-1, 1, 1, 1)
    vx = v[:, 0] * (1 - w0) + v[:, 1] * w0        # [M, 2y, 2yaw, 4]
    vy = vx[:, 0] * (1 - w1[:, :, None]) + vx[:, 1] * w1[:, :, None]
    val = vy[:, 0] * (1 - w2) + vy[:, 1] * w2     # [M, 4]
    g_yaw = (vy[:, 1] - vy[:, 0])[:, 1:4] / grid.yaw_resolution
    dy = vx[:, 1] - vx[:, 0]                      # [M, 2yaw, 4]
    g_y = (dy[:, 0] * (1 - w2) + dy[:, 1] * w2)[:, 1:4] / grid.xy_resolution
    dx = v[:, 1] - v[:, 0]                        # [M, 2y, 2yaw, 4]
    g_x = ((1 - w2) * (1 - w1) * dx[:, 0, 0] + (1 - w2) * w1 * dx[:, 1, 0]
           + w2 * (1 - w1) * dx[:, 0, 1]
           + w2 * w1 * dx[:, 1, 1])[:, 1:4] / grid.xy_resolution
    grad3 = torch.stack([g_x, g_y, g_yaw], dim=-1)   # [M, 3 rows, 3 cols]
    c = get_c(val)
    grad_c = -(grad3[:, 1] * val[:, 2:3] + grad3[:, 2] * val[:, 3:4]) \
        / c[:, None]
    grad = torch.cat([grad3, grad_c[:, None, :]], dim=1)          # [M, 4, 3]
    inside = is_in_map(grid, poses)
    return (torch.where(inside[:, None], val, 0.0),
            torch.where(inside[:, None, None], grad, 0.0))


def get_terrain_with_grad(grid: TerrainGrid, pos: torch.Tensor):
    """Values [..., 4] and analytic gradients [..., 4, 3]: rows d(sigma,
    zb0, zb1, c), columns d(x, y, yaw); the corner-difference derivative
    of the trilinear interpolation with the chain rule for c
    (uneven_map.h:258-315), not autograd."""
    return _batched(lambda p: _with_grad(grid, p), pos, (4,), (4, 3))


def terrain_variables_from_value(value: torch.Tensor,
                                 yaw: torch.Tensor) -> torch.Tensor:
    """[..., 7] terrain variables {invCosVphix, sinPhix, invCosVphiy,
    sinPhiy, cosXi, invCosXi, sigma} from RXS2 values [..., 4] and yaws
    [...] (uneven_map.h:221-256)."""
    zb0, zb1 = value[..., 2], value[..., 3]
    c = get_c(value)
    inv_c = 1.0 / c
    cyaw, syaw = torch.cos(yaw), torch.sin(yaw)
    t = cyaw * zb0 + syaw * zb1                   # xyaw . zb
    s = -(-syaw * zb0 + cyaw * zb1)               # -yyaw . zb
    sqrt_1_t2 = torch.sqrt(torch.clamp(1.0 - t * t, min=1e-12))
    inv_sqrt_1_t2 = 1.0 / sqrt_1_t2
    return torch.stack([inv_sqrt_1_t2, -c * t * inv_sqrt_1_t2,
                        sqrt_1_t2 * inv_c, s * inv_sqrt_1_t2, c, inv_c,
                        value[..., 1]], dim=-1)


def get_terrain_variables(grid: TerrainGrid,
                          pos: torch.Tensor) -> torch.Tensor:
    """[..., 7] terrain variables at [..., 3] SE(2) poses."""
    return terrain_variables_from_value(get_terrain(grid, pos), pos[..., 2])


def get_all_with_grad(grid: TerrainGrid, pos: torch.Tensor):
    """[..., 7] terrain variables and [..., 7, 3] gradients in (x, y, yaw)
    by the explicit chain rule of uneven_map.h:317-377 (the parity oracle
    of autograd through `get_terrain_variables`)."""
    value, rgrad = get_terrain_with_grad(grid, pos)  # rows sig, zb0, zb1, c
    zb0, zb1 = value[..., 2:3], value[..., 3:4]
    c = get_c(value)[..., None]
    inv_c = 1.0 / c
    yaw = pos[..., 2:3]
    cyaw, syaw = torch.cos(yaw), torch.sin(yaw)
    t = cyaw * zb0 + syaw * zb1
    s = syaw * zb0 - cyaw * zb1
    sqrt_1_t2 = torch.sqrt(torch.clamp(1.0 - t * t, min=1e-12))
    inv_sqrt = 1.0 / sqrt_1_t2
    inv_sqrt3 = inv_sqrt ** 3
    dzb0, dzb1 = rgrad[..., 1, :], rgrad[..., 2, :]   # [..., 3] each
    yaw_only = torch.zeros_like(dzb0)
    yaw_only[..., 2] = 1.0
    dt = dzb0 * cyaw + dzb1 * syaw - s * yaw_only
    ds = dzb0 * syaw - dzb1 * cyaw + t * yaw_only
    dc = rgrad[..., 3, :]
    values = terrain_variables_from_value(value, pos[..., 2])
    grads = torch.stack([
        t * inv_sqrt3 * dt,                                   # invCosVphix
        -(t * inv_sqrt * dc + inv_sqrt3 * c * dt),            # sinPhix
        -inv_c * (t * inv_sqrt * dt + sqrt_1_t2 * inv_c * dc),  # invCosVphiy
        inv_sqrt * ds + t * inv_sqrt3 * s * dt,               # sinPhiy
        dc,                                                   # cosXi
        -inv_c * inv_c * dc,                                  # invCosXi
        rgrad[..., 0, :],                                     # sigma
    ], dim=-2)
    return values, grads


def se3_lift(grid: TerrainGrid, pos: torch.Tensor):
    """Rotations R [..., 3, 3] (columns xb, yb, zb) and 3D positions
    [..., 3] at [..., 3] SE(2) poses (uneven_map.h:203-218)."""
    value = get_terrain(grid, pos)
    zb = torch.stack([value[..., 2], value[..., 3], get_c(value)], dim=-1)
    yaw = pos[..., 2]
    xyaw = torch.stack([torch.cos(yaw), torch.sin(yaw),
                        torch.zeros_like(yaw)], dim=-1)
    yb = torch.linalg.cross(zb, xyaw, dim=-1)
    yb = yb / torch.linalg.vector_norm(yb, dim=-1, keepdim=True)
    xb = torch.linalg.cross(yb, zb, dim=-1)
    R = torch.stack([xb, yb, zb], dim=-1)
    p = torch.stack([pos[..., 0], pos[..., 1], value[..., 0]], dim=-1)
    return R, p


def yaw_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """Yaws [...] of rotations [..., 3, 3] made by `se3_lift`
    (Sherman-Morrison form, uneven_map.cpp:56-62)."""
    p = R[..., :2, 2]
    b = R[..., :2, 0]
    pp = torch.sum(p * p, dim=-1)[..., None, None]
    eye = torch.eye(2, dtype=R.dtype, device=R.device)
    M = eye + p[..., :, None] * p[..., None, :] / (1.0 - pp)
    x = torch.sum(M * b[..., None, :], dim=-1)
    return torch.atan2(x[..., 1], x[..., 0])


def terrain_sigma(grid: TerrainGrid, pos: torch.Tensor) -> torch.Tensor:
    """[...] interpolated sigma at [..., 3] SE(2) poses."""
    return get_terrain(grid, pos)[..., 1]
