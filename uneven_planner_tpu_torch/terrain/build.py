"""Batched SE(2) plane-fit terrain-map constructor (port of
`uneven_planner_tpu/terrain/build.py`).

For every (x, y, yaw) cell, iter_num fixed-point iterations of {orient an
ellipsoid by the current surface estimate, collect the cloud points inside
it, PCA plane fit} (reference: uneven_map.cpp:317-417 constructMap, :5-43
filter).  The cloud is bucketed once on the host into a dense grid of
buckets sized to the search radius (numpy; the arrays of the JAX package,
bit for bit), and goes to the device once:

  cloud  [M+1, 4] float32 rows (x, y, z, 0); the last row is a far sentinel
  table  [nb, K] int32 rows: the point indices of one bucket, M = empty

A batch of cells (or of (x, y) columns, whose yaws share one candidate
set) reads the table rows of its bucket window and the cloud rows of their
candidates through the gather kernel K3 (`kernels/gather.py:gather_rows`).
The window's empty slots (most of it: K is the fullest bucket's count)
are squeezed out in window order before the cloud read, down to the
fullest window of the dispatch; they add nothing to any sum.  Dispatches
are sized so that the fullest window any cell can have (`window_bound`,
from the host's bucket counts) keeps the dense temporaries of one under
TEMP_BUDGET.  The fit is tensor arithmetic over
[cells, yaws, candidates], in the JAX package's order of operations, so
that points at the ellipsoid's edge fall on the same side.

Matches the reference cell semantics:
- probe point offset 0.12 m along body-x (uneven_map.cpp:342)
- iteration 0 seeds z from the nearest-in-xy cloud point (:346-355)
- empty neighbourhood -> default RXS2 with the probe z (:379-386)
- degenerate fit (NaN sigma) -> sigma=1, n=(1,0,0) (:33-37)
- sigma = 3*lambda_min/trace, z = mean z, normal flipped up (:28-38)
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.kernels.gather import gather_rows
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.grid import _div
from uneven_planner_tpu_torch.utils.profiling import span

# device bytes the temporaries of one dispatch may take when `chunk` is not
# given: ~8 float32 values live per (fit, candidate) pair at the peak of
# `_fit`, and ~20 bytes per slot of the bucket windows before they are
# squeezed (`_candidates`)
TEMP_BUDGET = {"cuda": 2 * 2 ** 30, "cpu": 256 * 2 ** 20}
TEMP_BYTES_PER_PAIR = 32
TEMP_BYTES_PER_SLOT = 20
SENTINEL = 1e6


class CloudBuckets(NamedTuple):
    """A bucket grid over the padded cloud, on the device."""
    cloud: torch.Tensor   # [M+1, 4] float32 (x, y, z, 0), row M the sentinel
    table: torch.Tensor   # [prod(nb), K] int32 point indices, M = empty
    counts: np.ndarray    # [*nb] int64 filled slots of each bucket (host)
    origin: tuple         # bucket grid origin
    size: float           # bucket edge length
    nb: tuple             # buckets along each axis

    @property
    def n_points(self) -> int:
        return self.cloud.shape[0] - 1


def _to_device(points, bucket, counts, lo, size, nb, device) -> CloudBuckets:
    dev = resolve_device(device)
    pts = np.zeros((points.shape[0] + 1, 4), np.float32)
    pts[:-1, :3] = points
    pts[-1, :3] = SENTINEL      # fails every membership test
    return CloudBuckets(
        cloud=torch.from_numpy(pts).to(dev),
        table=torch.from_numpy(bucket).to(dev), counts=counts,
        origin=tuple(float(v) for v in lo), size=float(size), nb=tuple(nb))


def build_buckets(points: np.ndarray, cfg: MapConfig,
                  bucket_size: float | None = None,
                  capacity: int | None = None, device=None) -> CloudBuckets:
    """Dense xy bucket grid (host-side; build.py:57-87).  A bucket over
    `capacity` keeps its first `capacity` points in cloud order."""
    r = max(cfg.ellipsoid_x, cfg.ellipsoid_y, cfg.ellipsoid_z)
    size = bucket_size or r
    lo = points[:, :2].min(axis=0) - 2 * size
    hi = points[:, :2].max(axis=0) + 2 * size
    nbx = int(math.ceil((hi[0] - lo[0]) / size))
    nby = int(math.ceil((hi[1] - lo[1]) / size))
    bx = np.floor((points[:, 0] - lo[0]) / size).astype(np.int64)
    by = np.floor((points[:, 1] - lo[1]) / size).astype(np.int64)
    flat = bx * nby + by
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat[order], minlength=nbx * nby)
    K = capacity or int(counts.max())
    M = points.shape[0]
    bucket = np.full((nbx * nby, K), M, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in range(nbx * nby):
        c = min(counts[b], K)
        bucket[b, :c] = order[starts[b]:starts[b] + c]
    return _to_device(points, bucket,
                      np.minimum(counts, K).reshape(nbx, nby), lo, size,
                      (nbx, nby), device)


def build_buckets3d(points: np.ndarray, cfg: MapConfig,
                    bucket_size: float | None = None,
                    capacity: int | None = None, device=None) -> CloudBuckets:
    """Dense xyz bucket grid (host-side; build.py:104-146) with
    distance-sorted truncation: a bucket over `capacity` keeps the points
    nearest its centre.  At least 5 x 5 x 6 buckets, so the windows of the
    yaw-shared sweep always fit."""
    r = max(cfg.ellipsoid_x, cfg.ellipsoid_y, cfg.ellipsoid_z)
    size = bucket_size or r
    lo = points.min(axis=0) - 2 * size
    hi = points.max(axis=0) + 2 * size
    nb = [max(int(math.ceil((hi[d] - lo[d]) / size)), m)
          for d, m in zip(range(3), (5, 5, 6))]
    bidx = [np.floor((points[:, d] - lo[d]) / size).astype(np.int64)
            for d in range(3)]
    flat = (bidx[0] * nb[1] + bidx[1]) * nb[2] + bidx[2]
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat[order], minlength=nb[0] * nb[1] * nb[2])
    kmax = int(counts.max())
    K = min(capacity, kmax) if capacity else kmax
    M = points.shape[0]
    bucket = np.full((nb[0] * nb[1] * nb[2], K), M, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in np.nonzero(counts)[0]:
        ids = order[starts[b]:starts[b] + counts[b]]
        if counts[b] > K:
            bz = np.array([(b // (nb[1] * nb[2])), (b // nb[2]) % nb[1],
                           b % nb[2]])
            center = lo + (bz + 0.5) * size
            d2 = np.sum((points[ids] - center) ** 2, axis=1)
            ids = ids[np.argsort(d2, kind="stable")[:K]]
        bucket[b, :len(ids)] = ids
    return _to_device(points, bucket, np.minimum(counts, K).reshape(nb), lo,
                      size, nb, device)


def nearest_z_seeds(points: np.ndarray, cfg: MapConfig) -> np.ndarray:
    """Exact 2D-nearest-neighbour z of every iteration-0 probe point
    (uneven_map.cpp:346-355), host-side: at iteration 0 the surface estimate
    is flat, so the probe xy of cell (x, y, yaw) is cell_xy + probe_offset *
    (cos yaw, sin yaw) and one KD query covers the map.  [n_cells] float32
    in cell-id order (build.py:149-168)."""
    from scipy.spatial import cKDTree
    nx, ny, nyaw = cfg.voxel_num
    ox, oy, oyaw = cfg.map_origin
    ids = np.arange(nx * ny * nyaw, dtype=np.int64)
    cx = ((ids // (ny * nyaw)) + 0.5) * cfg.xy_resolution + ox
    cy = (((ids // nyaw) % ny) + 0.5) * cfg.xy_resolution + oy
    cw = ((ids % nyaw) + 0.5) * cfg.yaw_resolution + oyaw
    px = cx + cfg.probe_offset * np.cos(cw)
    py = cy + cfg.probe_offset * np.sin(cw)
    tree = cKDTree(points[:, :2])
    _, nn = tree.query(np.stack([px, py], axis=1), workers=-1)
    return points[nn, 2].astype(np.float32)


def window_bound(b: CloudBuckets, window: tuple) -> int:
    """The most filled slots any window of `window` buckets (a box at any
    start the sweeps clip to) holds: the most candidates a cell keeps, which
    sizes the dispatches."""
    s = b.counts.astype(np.int64)
    for ax, w in enumerate(window):
        c = np.cumsum(s, axis=ax)
        c = np.concatenate([np.zeros_like(c.take([0], axis=ax)), c], axis=ax)
        n = c.shape[ax]
        s = c.take(range(w, n), axis=ax) - c.take(range(n - w), axis=ax)
    return max(int(s.max()), 1)


# ---------------------------------------------------------------------------
# The fit, batched: one candidate set [C, G] per row, W fits per row
# ---------------------------------------------------------------------------

def _candidates(b: CloudBuckets, block: torch.Tensor):
    """Point indices [C, G] of the buckets `block` [C, nblk] (row ids of
    the table), filled slots first in window order and padded with M to G,
    the fullest row's count (one read to the host); and their cloud rows
    [C, G, 4].  Both reads go through K3."""
    C = block.shape[0]
    M = b.n_points
    idx = gather_rows(b.table, block.reshape(-1)).reshape(C, -1)
    valid = idx < M
    slot = torch.cumsum(valid, dim=1, dtype=torch.int32) - 1
    G = max(int(slot[:, -1].max()) + 1, 1)
    slot = torch.where(valid, slot, G).to(torch.int64)
    packed = torch.full((C, G + 1), M, dtype=torch.int32, device=idx.device)
    packed.scatter_(1, slot, idx)
    idx = packed[:, :G].contiguous()
    rows = gather_rows(b.cloud, idx.reshape(-1)).reshape(C, G, 4)
    return idx, rows


def _frames(zb0, zb1, yaw):
    """Body frame rows (xb, yb, zb) [..., 3] from the surface estimate's zb
    and the yaw (build.py:189-196)."""
    c = torch.sqrt(torch.clamp(1.0 - (zb0 * zb0 + zb1 * zb1), min=1e-12))
    xyaw = torch.stack([torch.cos(yaw), torch.sin(yaw),
                        torch.zeros_like(yaw)], dim=-1)
    zb3 = torch.stack([zb0, zb1, c], dim=-1)
    yb = torch.linalg.cross(zb3, xyaw, dim=-1)
    yb = yb / torch.sqrt(torch.clamp(torch.sum(yb * yb, dim=-1, keepdim=True),
                                     min=1e-30))
    xb = torch.linalg.cross(yb, zb3, dim=-1)
    return xb, yb, zb3


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors along the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def _eigh3_smallest(cov: torch.Tensor):
    """Eigenvalues (ascending) [..., 3] and the smallest one's unit
    eigenvector [..., 3] of symmetric [..., 3, 3] matrices, closed form
    (build.py:351-370): trigonometric eigenvalues; the eigenvector is the
    largest column of (A - l1 I)(A - l2 I), the first of equal ones."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    q = _div(cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2], 3.0)
    B = cov - q[..., None, None] * eye
    p2 = _div(torch.sum(B * B, dim=(-2, -1)), 6.0)
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = _det3(B / p[..., None, None])
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = _div(torch.arccos(r), 3.0)
    l1 = q + 2 * p * torch.cos(phi)
    l3 = q + 2 * p * torch.cos(phi + 2 * math.pi / 3.0)
    l2 = 3 * q - l1 - l3
    C = torch.matmul(cov - l1[..., None, None] * eye,
                     cov - l2[..., None, None] * eye)
    norms = torch.sum(C * C, dim=-2)
    k = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(C, k[..., None, None].expand(
        *k.shape, 3, 1), dim=-1)[..., 0]
    v = v / torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                   min=1e-30))
    return torch.stack([l3, l2, l1], dim=-1), v


def _fit(idx, rows, M, wxy, z0, frames, cfg: MapConfig) -> torch.Tensor:
    """Plane fits [C, W, 4] of W probes per candidate set: candidates idx
    [C, G] and rows [C, G, 4], probe xy wxy [C, W, 2] and z z0 [C, W], body
    frames (xb, yb, zb) [C, W, 3] each (build.py:300-347)."""
    g = rows[..., :3].transpose(1, 2)                     # [C, 3, G]
    gx, gy, gz = (g[:, k, None, :] for k in range(3))     # [C, 1, G]
    valid = (idx < M)[:, None, :]
    rx = gx - wxy[..., 0, None]
    ry = gy - wxy[..., 1, None]
    rz = gz - z0[..., None]
    q = None
    for RTk, e in zip(frames, (cfg.ellipsoid_x, cfg.ellipsoid_y,
                               cfg.ellipsoid_z)):
        a = rx * RTk[..., 0, None]
        a.add_(ry * RTk[..., 1, None])
        a.add_(rz * RTk[..., 2, None])
        a = _div(a, e)
        a.mul_(a)
        q = a if q is None else q.add_(a)
    del rx, ry, rz
    member = valid & (q < 1.0)
    del q
    n = member.sum(dim=-1)
    w = member.to(rows.dtype)
    del member
    denom = torch.clamp(n.to(rows.dtype), min=1.0)[..., None]
    mean = torch.matmul(w, g.transpose(1, 2)) / denom     # [C, W, 3]
    cen = g[:, None] - mean[..., None]                     # [C, W, 3, G]
    cen.mul_(w[:, :, None, :])
    del w
    cov = torch.matmul(cen, cen.transpose(-1, -2)) / denom[..., None]
    del cen
    evals, v = _eigh3_smallest(cov)
    v = torch.where(v[..., 2:3] < 0.0, -v, v)
    tr = torch.sum(evals, dim=-1)
    sigma = 3.0 * evals[..., 0] / tr
    bad = ~torch.isfinite(sigma) | (tr <= 1e-20)
    sigma = torch.where(bad, 1.0, sigma)
    v = torch.where(bad[..., None], v.new_tensor([1.0, 0.0, 0.0]), v)
    fitted = torch.stack([mean[..., 2], sigma, v[..., 0], v[..., 1]], -1)
    empty = torch.stack([z0, torch.zeros_like(z0), torch.zeros_like(z0),
                         torch.zeros_like(z0)], -1)
    return torch.where((n > 0)[..., None], fitted, empty)


def _probe(cell_xy, xb, cfg):
    return cell_xy + xb[..., :2] * cfg.probe_offset


def _clip_bucket(coord, origin, b: CloudBuckets, axis, lo_margin,
                 hi_margin):
    """Bucket index of `coord` along `axis`, truncated toward zero as
    astype(jnp.int32) truncates, and clipped `lo_margin` and `hi_margin`
    buckets from the grid's ends."""
    i = _div(coord - origin, b.size).to(torch.int32)
    return i.clamp(lo_margin, b.nb[axis] - 1 - hi_margin)


def _box(b: CloudBuckets, starts, extent):
    """Table row ids [C, prod(extent)] of the bucket boxes at `starts`
    (one [C] int32 tensor per axis), the first axis slowest."""
    dev = starts[0].device
    ids = torch.zeros_like(starts[0])[:, None]
    for s, e, nb in zip(starts, extent, b.nb):
        off = torch.arange(e, dtype=torch.int32, device=dev)
        ids = (ids[:, :, None] * nb + (s[:, None, None] + off)) \
            .reshape(s.shape[0], -1)
    return ids


def _fit_cell(cells, prev, b: CloudBuckets, cfg: MapConfig,
              first_iter: bool):
    """One plane-fit iteration of cells [C, 3] (x, y, yaw) from their
    previous values prev [C, 4] (z, sigma, zb0, zb1) over the xy buckets'
    3 x 3 window (build.py:373-458) -> [C, 4]."""
    xb, yb, zb3 = _frames(prev[:, 2], prev[:, 3], cells[:, 2])
    wxy = _probe(cells[:, :2], xb, cfg)
    ox, oy = b.origin
    bx = _clip_bucket(wxy[:, 0], ox, b, 0, 1, 1)
    by = _clip_bucket(wxy[:, 1], oy, b, 1, 1, 1)
    idx, rows = _candidates(b, _box(b, (bx - 1, by - 1), (3, 3)))
    if first_iter:
        # z seed: the nearest valid candidate in xy, the first of equals;
        # the previous z where there is none (uneven_map.cpp:346-355)
        d2 = (rows[..., 0] - wxy[:, 0, None]) ** 2 \
            + (rows[..., 1] - wxy[:, 1, None]) ** 2
        valid = idx < b.n_points
        d2 = torch.where(valid, d2, math.inf)
        z0 = torch.take_along_dim(rows[..., 2], torch.argmin(d2, dim=1,
                                                             keepdim=True),
                                  dim=1)[:, 0]
        z0 = torch.where(valid.any(dim=1), z0, prev[:, 0])
    else:
        z0 = prev[:, 0]
    one = lambda t: t[:, None]
    return _fit(idx, rows, b.n_points, one(wxy), one(z0),
                (one(xb), one(yb), one(zb3)), cfg)[:, 0]


def _fit_cell3d(cells, prev, seed_z, b: CloudBuckets, cfg: MapConfig,
                first_iter: bool):
    """One plane-fit iteration of cells [C, 3] over the 3D buckets' 3 x 3 x 3
    window around (probe xy, z0), z0 the exact KD seed seed_z [C] at
    iteration 0 (build.py:180-253) -> [C, 4]."""
    xb, yb, zb3 = _frames(prev[:, 2], prev[:, 3], cells[:, 2])
    wxy = _probe(cells[:, :2], xb, cfg)
    z0 = seed_z if first_iter else prev[:, 0]
    ox, oy, oz = b.origin
    bx = _clip_bucket(wxy[:, 0], ox, b, 0, 1, 1)
    by = _clip_bucket(wxy[:, 1], oy, b, 1, 1, 1)
    bz = _clip_bucket(z0, oz, b, 2, 1, 1)
    idx, rows = _candidates(b, _box(b, (bx - 1, by - 1, bz - 1), (3, 3, 3)))
    one = lambda t: t[:, None]
    return _fit(idx, rows, b.n_points, one(wxy), one(z0),
                (one(xb), one(yb), one(zb3)), cfg)[:, 0]


def _fit_yaw_block(cell_xy, yaws, prev, seed_z, b: CloudBuckets,
                   cfg: MapConfig, first_iter: bool):
    """All W yaw fits of each (x, y) column off one shared candidate set
    (build.py:256-348): a 5 x 5 x NZ bucket block per column (xy coverage
    +-0.4 m covers the 0.12 m probe circle plus the 0.2 m ellipsoid; the z
    window starts one ellipsoid radius below the column's lowest z0).  The
    JAX package scans the yaws with an unused carry, so it is a map: here
    one tensor op over [C, W, G] does them all.

    cell_xy [C, 2]; yaws [W]; prev [C, W, 4]; seed_z [C, W] -> [C, W, 4]."""
    nbz = b.nb[2]
    NZ = min(6, nbz)
    r_ell = max(cfg.ellipsoid_x, cfg.ellipsoid_y, cfg.ellipsoid_z)
    z0 = seed_z if first_iter else prev[..., 0]
    ox, oy, oz = b.origin
    bx = _clip_bucket(cell_xy[:, 0], ox, b, 0, 2, 2)
    by = _clip_bucket(cell_xy[:, 1], oy, b, 1, 2, 2)
    bz = _div(z0.amin(dim=1) - r_ell - oz, b.size).to(torch.int32) \
        .clamp(0, nbz - NZ)
    idx, rows = _candidates(b, _box(b, (bx - 2, by - 2, bz), (5, 5, NZ)))
    frames = _frames(prev[..., 2], prev[..., 3],
                     yaws[None, :].expand(cell_xy.shape[0], -1))
    wxy = _probe(cell_xy[:, None, :], frames[0], cfg)
    return _fit(idx, rows, b.n_points, wxy, z0, frames, cfg)


# ---------------------------------------------------------------------------
# The whole map
# ---------------------------------------------------------------------------

def _per_dispatch(chunk, b: CloudBuckets, window, W, dev) -> int:
    """Rows (cells or columns of W fits each) per dispatch over bucket
    windows of shape `window`: `chunk` fits, or as many as TEMP_BUDGET
    allows when every row holds the fullest window there is."""
    if chunk:
        return max(1, chunk // W)
    per_row = W * window_bound(b, window) * TEMP_BYTES_PER_PAIR \
        + math.prod(window) * b.table.shape[1] * TEMP_BYTES_PER_SLOT
    return max(1, TEMP_BUDGET[dev.type] // per_row)


def construct_map(points: np.ndarray, cfg: MapConfig,
                  chunk: int | None = None, dtype=torch.float32,
                  bucket_capacity: int | None = None, mode: str = "auto",
                  device=None, timings: dict | None = None
                  ) -> tgrid.TerrainGrid:
    """The RXS2 grid of a cropped, downsampled cloud [N, 3] on `device`
    (None: CUDA), by iter_num sweeps of plane fits (build.py:461-575).

    mode: "yawshare" (and "auto"): 3D buckets, exact KD z-seeds, one
    shared 5 x 5 x 6 window per (x, y) column for all its yaws; "xyz":
    per-cell 3 x 3 x 3 windows of 3D buckets; "xy": per-cell 3 x 3 windows
    of xy buckets, seeded from the window's nearest point.  `chunk` caps the
    fits per dispatch (None: sized by TEMP_BUDGET).  The sweep runs in
    float32, the cloud's precision; the field is returned in `dtype`.
    `timings`, when given, receives the seconds of the host's bucketing
    and seeding ("host_s") and of the device sweep ("device_s", ending in
    a synchronisation).  Spans: `up.construct_map`, and under it
    `.buckets`, `.seeds` (the nearest-z seeds; not in mode "xy") and
    `.sweep`."""
    dev = resolve_device(device)
    nx, ny, nyaw = cfg.voxel_num
    ox, oy, oyaw = cfg.map_origin
    if mode == "auto":
        mode = "yawshare"
    if mode not in ("yawshare", "xyz", "xy"):
        raise ValueError(f"unknown map-building mode {mode!r}")
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.float32)).to(dev)
    with span("up.construct_map"):
        t0 = time.perf_counter()
        if mode == "yawshare":
            # the 5 x 5 window of 0.2 m buckets covers the probe circle plus
            # the ellipsoid only while the probe stays within one bucket
            if cfg.probe_offset > max(cfg.ellipsoid_x, cfg.ellipsoid_y,
                                      cfg.ellipsoid_z):
                raise ValueError("yawshare needs probe_offset <= the largest "
                                 "ellipsoid semi-axis (the bucket size)")
            with span("up.construct_map.buckets"):
                b = build_buckets3d(points, cfg, capacity=bucket_capacity,
                                    device=dev)
            with span("up.construct_map.seeds"):
                seeds = f32(nearest_z_seeds(points, cfg)
                            .reshape(nx * ny, nyaw))
            ids = np.arange(nx * ny, dtype=np.int64)
            cell_xy = f32(np.stack(
                [((ids // ny) + 0.5) * cfg.xy_resolution + ox,
                 ((ids % ny) + 0.5) * cfg.xy_resolution + oy], axis=1))
            yaws = f32((np.arange(nyaw) + 0.5) * cfg.yaw_resolution + oyaw)
            t1 = time.perf_counter()
            with span("up.construct_map.sweep"):
                step = _per_dispatch(chunk, b, (5, 5, min(6, b.nb[2])), nyaw,
                                     dev)
                values = torch.zeros((nx * ny, nyaw, 4), dtype=torch.float32,
                                     device=dev)
                for it in range(cfg.iter_num):
                    for lo in range(0, nx * ny, step):
                        s = slice(lo, lo + step)
                        values[s] = _fit_yaw_block(cell_xy[s], yaws,
                                                   values[s], seeds[s], b,
                                                   cfg, it == 0)
        else:
            ids = np.arange(nx * ny * nyaw, dtype=np.int64)
            cells = f32(np.stack([
                ((ids // (ny * nyaw)) + 0.5) * cfg.xy_resolution + ox,
                (((ids // nyaw) % ny) + 0.5) * cfg.xy_resolution + oy,
                ((ids % nyaw) + 0.5) * cfg.yaw_resolution + oyaw], axis=1))
            if mode == "xyz":
                with span("up.construct_map.buckets"):
                    b = build_buckets3d(points, cfg,
                                        capacity=bucket_capacity, device=dev)
                with span("up.construct_map.seeds"):
                    seeds = f32(nearest_z_seeds(points, cfg))
                window = (3, 3, 3)
                fit = lambda c, v, s, first: _fit_cell3d(
                    c, v, seeds[s], b, cfg, first)
            else:
                with span("up.construct_map.buckets"):
                    b = build_buckets(points, cfg, capacity=bucket_capacity,
                                      device=dev)
                window = (3, 3)
                fit = lambda c, v, s, first: _fit_cell(c, v, b, cfg, first)
            t1 = time.perf_counter()
            with span("up.construct_map.sweep"):
                step = _per_dispatch(chunk, b, window, 1, dev)
                values = torch.zeros((nx * ny * nyaw, 4),
                                     dtype=torch.float32, device=dev)
                for it in range(cfg.iter_num):
                    for lo in range(0, nx * ny * nyaw, step):
                        s = slice(lo, lo + step)
                        values[s] = fit(cells[s], values[s], s, it == 0)

        data = values.reshape(nx, ny, nyaw, 4).to(dtype)
        grid = tgrid.from_buffers(
            data, min_cnormal=cfg.min_cnormal, max_rho=cfg.max_rho,
            xy_resolution=cfg.xy_resolution,
            yaw_resolution=cfg.yaw_resolution, origin=cfg.map_origin,
            gravity=cfg.gravity)
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.update(host_s=t1 - t0,
                           device_s=time.perf_counter() - t1)
    return grid
