"""Polynomial real-root isolation for trajectory rate diagnostics (port of
`uneven_planner_tpu/utils/rootfinder.py`).

The reference's RootFinder (root_finder.hpp: closed-form cubic/quartic,
companion-matrix eigenvalues, Sturm isolation) serves only the
max-velocity diagnostics (se2traj.hpp:152-251).  As in the JAX package this
is a fixed-iteration Durand-Kerner simultaneous root iteration: branchless,
batched over leading dimensions, and exact enough for diagnostics.
Polynomials are coefficient tensors [..., d+1], highest degree first.
"""

from __future__ import annotations

import torch


def poly_sqr(p: torch.Tensor) -> torch.Tensor:
    """Coefficients [..., 2d+1] of p(x)^2 (RootFinder::polySqr,
    root_finder.hpp:850)."""
    n = p.shape[-1]
    out = p.new_zeros(p.shape[:-1] + (2 * n - 1,))
    for i in range(n):
        out[..., i:i + n] += p[..., i:i + 1] * p
    return out


def poly_val(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of p [d+1] at x [...] (polyVal,
    root_finder.hpp:885); p may carry the leading dimensions of x."""
    acc = torch.zeros_like(x)
    for i in range(p.shape[-1]):
        acc = acc * x + p[..., i]
    return acc


def poly_der(p: torch.Tensor) -> torch.Tensor:
    """Coefficients [..., d] of p'."""
    n = p.shape[-1] - 1
    k = torch.arange(n, 0, -1, dtype=p.dtype, device=p.device)
    return p[..., :-1] * k


def roots(p: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """All complex roots [..., d] by Durand-Kerner of p [..., d+1] (the
    leading coefficient regularized away from 0)."""
    n = p.shape[-1] - 1
    cdtype = torch.complex64 if p.dtype == torch.float32 \
        else torch.complex128
    lead = p[..., :1]
    lead = torch.where(torch.abs(lead) < 1e-12, 1e-12, lead)
    mon = (p / lead).to(cdtype)
    k = torch.arange(n, device=p.device)
    z = ((0.4 + 0.9j) ** (k + 1).to(cdtype)).expand(p.shape[:-1] + (n,))
    eye = torch.eye(n, dtype=cdtype, device=p.device)
    for _ in range(iters):
        pz = poly_val(mon[..., None, :], z)
        diff = z[..., :, None] - z[..., None, :] + eye  # no self-division
        z = z - pz / torch.prod(diff, dim=-1)
    return z


def real_roots_in_01(p: torch.Tensor, tol: float = 1e-6):
    """Real roots clipped to [0, 1], with a validity mask."""
    z = roots(p)
    real = z.real
    ok = (torch.abs(z.imag) < tol * (1.0 + torch.abs(real))) \
        & (real > -tol) & (real < 1.0 + tol)
    return torch.clamp(real, 0.0, 1.0), ok


def max_dot_value_norm(c_piece: torch.Tensor, T: torch.Tensor):
    """Exact max ||velocity|| [...] over quintic pieces c_piece [..., 6, Dim]
    (ascending coefficients) of durations T [...], from the roots of
    d/du ||v||^2 on the normalized domain u = t/T in [0, 1]
    (Piece::getMaxDotValueNorm, se2traj.hpp:152-201)."""
    dt = c_piece.dtype
    n = torch.arange(1, 6, dtype=dt, device=c_piece.device)
    pow_T = T[..., None] ** n                                # T^1..T^5
    # normalized velocity coefficients in u, highest first [..., 5, Dim]
    v_desc = (c_piece[..., 1:, :] * n[:, None]
              * pow_T[..., None]).flip(-2)
    sq = poly_sqr(v_desc.transpose(-1, -2)).sum(-2)         # [..., 9]
    cand, ok = real_roots_in_01(poly_der(sq))
    ends = torch.tensor([0.0, 1.0], dtype=dt, device=c_piece.device)
    cand = torch.cat([cand, ends.expand(cand.shape[:-1] + (2,))], -1)
    ok = torch.cat([ok, torch.ones_like(ok[..., :2])], -1)
    vals = poly_val(sq[..., None, :], cand)
    vals = torch.where(ok, vals, -torch.inf)
    return torch.sqrt(torch.clamp(vals.amax(-1), min=0.0)) / T


def max_vel_rate_exact(c_xy: torch.Tensor, ts: torch.Tensor):
    """Max ||v|| [...] over whole trajectories c_xy [..., N, 6, Dim] with
    piece durations ts [..., N] (PolyTrajectory::getMaxDotValueNorm,
    se2traj.hpp:381-392)."""
    return max_dot_value_norm(c_xy, ts).amax(-1)
