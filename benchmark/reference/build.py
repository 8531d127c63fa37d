"""Plain reference of the terrain map's cells: the plane fits of the
reference map builder (uneven_map.cpp:317-417 constructMap and its filter
:5-43), cell by cell, brute force over the whole cloud, in float64.

For a cell (x, y, yaw) and `iter_num` iterations from a flat estimate: the
body frame from the estimate's normal and the yaw; the probe point
`probe_offset` ahead along the body's x; at the first iteration its z the
z of the cloud point nearest in xy, later the estimate's z; the cloud
points inside the ellipsoid about the probe in the body frame; their
mean z, and the eigenvector of their covariance's smallest eigenvalue as
the normal (turned up), sigma = 3 lambda_min / trace.  No point: the
probe's z and zeros.  A degenerate fit: sigma 1 and the normal (1, 0).
Occupancy: the normal's z below `min_cnormal` or sigma above `max_rho`.

A cell one of whose decisions lies within the program's rounding of the
boundary (a point within `AMBIGUOUS` of the ellipsoid's surface, or two
nearest points within it of each other), or whose fit has fewer than 3
points (no plane is determined), is marked, since float32 and float64 may
rightly decide it apart.

`Arith(tf32=True)` (`reference/arith.py`) is the control: the
sums of the fit as matrix products in float32 with TF32 operands.
It imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.arith import Arith

AMBIGUOUS = 1e-5
BLOCK = 16


def _frames(zb0, zb1, yaw):
    c = torch.sqrt(torch.clamp(1.0 - zb0 * zb0 - zb1 * zb1, min=1e-12))
    zb = torch.stack([zb0, zb1, c], -1)
    xyaw = torch.stack([torch.cos(yaw), torch.sin(yaw),
                        torch.zeros_like(yaw)], -1)
    yb = torch.linalg.cross(zb, xyaw, dim=-1)
    yb = yb / torch.linalg.vector_norm(yb, dim=-1, keepdim=True)
    xb = torch.linalg.cross(yb, zb, dim=-1)
    return torch.stack([xb, yb, zb], 1)            # [C, 3 rows, 3]


def _nearest_z(cloud, probe):
    """z of the cloud point nearest in xy to each probe [C, 2], and
    whether the second nearest lies within rounding of it."""
    d2 = ((cloud[None, :, :2] - probe[:, None, :]) ** 2).sum(-1)
    two = torch.topk(d2, 2, dim=1, largest=False)
    tie = (two.values[:, 1] - two.values[:, 0]) \
        <= AMBIGUOUS * two.values[:, 1].clamp(min=1e-12)
    return cloud[two.indices[:, 0], 2], tie


def _fit_block(cloud, cells, prev, first, cfg: dict, ar: Arith):
    """One iteration of the fit of cells [C, 3] from prev [C, 4]:
    ([C, 4] (z, sigma, n_x, n_y), ambiguous [C], conditioning [C])."""
    dt = ar.dtype
    R = _frames(prev[:, 2], prev[:, 3], cells[:, 2])
    probe = cells[:, :2] + cfg["probe_offset"] * R[:, 0, :2]
    if first:
        z0, amb = _nearest_z(cloud, probe)
    else:
        z0, amb = prev[:, 0], torch.zeros_like(prev[:, 0], dtype=torch.bool)
    centre = torch.cat([probe, z0[:, None]], 1)
    rel = cloud[None] - centre[:, None]                        # [C, M, 3]
    body = torch.einsum("cmk,cjk->cmj", rel, R)
    axes = torch.tensor([cfg["ellipsoid_x"], cfg["ellipsoid_y"],
                         cfg["ellipsoid_z"]], dtype=rel.dtype,
                        device=rel.device)
    q = ((body / axes) ** 2).sum(-1)
    amb = amb | ((q - 1.0).abs() < AMBIGUOUS).any(1)
    w = (q < 1.0).to(dt)                                       # [C, M]
    n = w.sum(1)
    amb = amb | ((n > 0) & (n < 3))
    pts = cloud.to(dt)
    denom = n.clamp(min=1.0)[:, None]
    mean = ar.mm(w, pts) / denom                               # [C, 3]
    cen = (pts[None] - mean[:, None]) * w[..., None]           # [C, M, 3]
    cov = ar.mm(cen.transpose(1, 2), cen) / denom[..., None]
    evals, evecs = torch.linalg.eigh(cov.double())
    v = evecs[..., 0]
    v = torch.where(v[:, 2:3] < 0, -v, v)
    tr = evals.sum(-1)
    sigma = 3.0 * evals[:, 0] / tr
    bad = ~torch.isfinite(sigma) | (tr <= 1e-20)
    sigma = torch.where(bad, torch.ones_like(sigma), sigma)
    v = torch.where(bad[:, None], v.new_tensor([1.0, 0.0, 0.0]), v)
    fitted = torch.stack([mean[:, 2].double(), sigma, v[:, 0], v[:, 1]], -1)
    empty = torch.stack([z0.double()] + [torch.zeros_like(z0.double())] * 3,
                        -1)
    # the normal's conditioning: the gap between the two least eigenvalues
    # over the trace; rounding the covariance by a share e of its trace
    # moves the normal by about e over this (an empty fit's normal is set,
    # not fitted: 1)
    cond = ((evals[:, 1] - evals[:, 0]) / tr).clamp(0.0, 1.0)
    cond = torch.where(bad, torch.zeros_like(cond), cond)
    cond = torch.where(n > 0, cond, torch.ones_like(cond))
    return torch.where((n > 0)[:, None], fitted, empty), amb, cond


def cell_fits(cloud: torch.Tensor, cells: torch.Tensor, cfg: dict,
              ar: Arith = Arith()):
    """The fits [C, 4] (z, sigma, n_x, n_y) after cfg["iter_num"]
    iterations of cells [C, 3] (x, y, yaw positions), which cells are
    ambiguous [C], and the last fit's normal conditioning [C] (the two
    least eigenvalues' gap over the trace); cloud [M, 3].  Blocks of
    BLOCK cells at a time."""
    cloud = cloud.double()
    out, amb, conds = [], [], []
    for lo in range(0, cells.shape[0], BLOCK):
        c = cells[lo:lo + BLOCK].double()
        v = c.new_zeros((c.shape[0], 4))
        a = torch.zeros(c.shape[0], dtype=torch.bool, device=c.device)
        for it in range(cfg["iter_num"]):
            v, ai, cond = _fit_block(cloud, c, v, it == 0, cfg, ar)
            a = a | ai
        out.append(v)
        amb.append(a)
        conds.append(cond)
    return torch.cat(out), torch.cat(amb), torch.cat(conds)


def normals(fits: torch.Tensor) -> torch.Tensor:
    """[C, 3] unit normals (turned up) of the fits' n_x, n_y."""
    nx, ny = fits[:, 2].double(), fits[:, 3].double()
    return torch.stack([nx, ny, torch.sqrt(torch.clamp(
        1.0 - nx * nx - ny * ny, min=0.0))], -1)


def occupied(fits: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[C] bool: the cells the map marks occupied."""
    return (normals(fits)[:, 2] < cfg["min_cnormal"]) \
        | (fits[:, 1] > cfg["max_rho"])


def near_threshold(fits: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[C] bool: cells whose occupancy float32 may rightly decide apart:
    sigma within 1% of `max_rho` (float32's sigma lies ~0.2% from
    float64's) or the normal's z within AMBIGUOUS of `min_cnormal`."""
    return ((fits[:, 1] - cfg["max_rho"]).abs() < 0.01 * cfg["max_rho"]) \
        | ((normals(fits)[:, 2] - cfg["min_cnormal"]).abs() < AMBIGUOUS)
