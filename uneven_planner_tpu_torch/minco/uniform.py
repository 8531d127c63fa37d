"""Uniform-piece-time MINCO as constant-matrix matmuls (port of
`uneven_planner_tpu/minco/uniform.py`).

With uniform piece times T_piece = T/N the whole 6N x 6N MINCO solve
collapses to one matmul with a constant inverse G (computed once per N in
float64 numpy, exactly as the JAX package does), and sampling at the
solver's fixed fractions u_j = j/K is a constant matmul too, with the yaw
piece of every xy sample folded in statically.  The constants live in a
frozen `UniformOps` built once per (N, Nyaw, K, dtype, device).

All functions here are batched over a leading lane dimension B.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def _beta_np(u: np.ndarray):
    """numpy beta rows (value/vel/acc/jerk) at normalized time u."""
    u = np.asarray(u, np.float64)
    o, l = np.zeros_like(u), np.ones_like(u)
    b0 = np.stack([l, u, u**2, u**3, u**4, u**5], axis=-1)
    b1 = np.stack([o, l, 2*u, 3*u**2, 4*u**3, 5*u**4], axis=-1)
    b2 = np.stack([o, o, 2*l, 6*u, 12*u**2, 20*u**3], axis=-1)
    b3 = np.stack([o, o, o, 6*l, 24*u, 60*u**2], axis=-1)
    return b0, b1, b2, b3


@functools.lru_cache(maxsize=None)
def _solve_matrix(N: int) -> np.ndarray:
    """G [6N, N+5]: normalized-coefficient solve operator for N pieces.

    Column order: N-1 waypoints, then head (p, v~, a~), then tail (p, v~, a~)
    with v~ = T_piece * v, a~ = T_piece^2 * a.
    """
    assert N >= 2
    n = 6 * N
    A = np.zeros((n, n), np.float64)
    rhs_rows = []  # (row, rhs column) pairs

    b0_1, b1_1, b2_1, b3_1 = _beta_np(np.float64(1.0))
    b4_1 = np.array([0.0, 0.0, 0.0, 0.0, 24.0, 120.0])  # snap basis at u=1
    dfact = np.array([1.0, 1.0, 2.0, 6.0, 24.0])        # d! for d = 0..4

    row = 0
    # head rows: c[0,0]=hp, c[0,1]=hv~, 2 c[0,2]=ha~
    A[row, 0] = 1.0
    rhs_rows.append((row, N - 1 + 0))
    row += 1
    A[row, 1] = 1.0
    rhs_rows.append((row, N - 1 + 1))
    row += 1
    A[row, 2] = 2.0
    rhs_rows.append((row, N - 1 + 2))
    row += 1

    bders = [b0_1, b1_1, b2_1, b3_1, b4_1]
    for i in range(N - 1):
        # waypoint: sum_k c[i,k] = q_i
        A[row, 6*i:6*i+6] = b0_1
        rhs_rows.append((row, i))
        row += 1
        # continuity of derivative order d = 0..4 at the junction
        for d in range(5):
            A[row, 6*i:6*i+6] = bders[d]
            A[row, 6*(i+1) + d] = -dfact[d]
            row += 1

    # tail rows
    A[row, 6*(N-1):] = b0_1
    rhs_rows.append((row, N - 1 + 3))
    row += 1
    A[row, 6*(N-1):] = b1_1
    rhs_rows.append((row, N - 1 + 4))
    row += 1
    A[row, 6*(N-1):] = b2_1
    rhs_rows.append((row, N - 1 + 5))
    row += 1
    assert row == n

    Ainv = np.linalg.inv(A)
    G = np.zeros((n, N + 5), np.float64)
    for r, c in rhs_rows:
        G[:, c] += Ainv[:, r]
    return G


# Jerk energy quadratic form: q_kl = int_0^1 beta3_k beta3_l du, rows 3..5.
_JERK_Q = np.zeros((6, 6), np.float64)
_JERK_Q[3:, 3:] = np.array([[36.0, 72.0, 120.0],
                            [72.0, 192.0, 360.0],
                            [120.0, 360.0, 720.0]])


@functools.lru_cache(maxsize=None)
def _jerk_q_block(N: int) -> np.ndarray:
    """Block-diagonal [6N, 6N] jerk quadratic form (one _JERK_Q per piece)."""
    Q = np.zeros((6 * N, 6 * N), np.float64)
    for i in range(N):
        Q[6*i:6*i+6, 6*i:6*i+6] = _JERK_Q
    return Q


@functools.lru_cache(maxsize=None)
def sample_plan(N: int, Nyaw: int, K: int):
    """Constant sampling operators for the ALM constraint grid.

    Returns numpy arrays:
      B0, B1, B2:   [K+1, 6] xy bases at u_j = j/K
      yidx:         [N, K+1] int32 yaw piece index of each xy sample
      BY0, BY1:     [N, K+1, 6] yaw bases at the per-sample normalized
                    local yaw time
    """
    K1 = K + 1
    u = np.arange(K1, dtype=np.float64) / K
    B0, B1, B2, _ = _beta_np(u)

    i = np.arange(N, dtype=np.float64)[:, None]
    g = (i + u[None, :]) * (Nyaw / N)          # global time / T_piece_yaw
    yidx = np.minimum(np.floor(g + 1e-12).astype(np.int64), Nyaw - 1)
    uy = g - yidx
    BY0, BY1, _, _ = _beta_np(uy)
    return (B0, B1, B2, yidx.astype(np.int32), BY0, BY1)


@functools.lru_cache(maxsize=None)
def sample_matrices(N: int, Nyaw: int, K: int):
    """Dense sampling operators (numpy float64) mapping normalized
    coefficients to the flat [S = N*(K+1)] constraint-sample grid:
      SXY  [3S, 6N]:    position, d/du, d2/du2 rows
      SYAW [2S, 6Nyaw]: yaw value, d/du_yaw rows (yaw piece folded in)
    """
    K1 = K + 1
    S = N * K1
    B0, B1, B2, yidx, BY0, BY1 = sample_plan(N, Nyaw, K)
    SXY = np.zeros((3 * S, 6 * N), np.float64)
    for i in range(N):
        r = i * K1
        SXY[r:r + K1, 6*i:6*i+6] = B0
        SXY[S + r:S + r + K1, 6*i:6*i+6] = B1
        SXY[2*S + r:2*S + r + K1, 6*i:6*i+6] = B2
    SYAW = np.zeros((2 * S, 6 * Nyaw), np.float64)
    yf = yidx.reshape(-1)
    b0f = BY0.reshape(-1, 6)
    b1f = BY1.reshape(-1, 6)
    for s in range(S):
        SYAW[s, 6*yf[s]:6*yf[s]+6] = b0f[s]
        SYAW[S + s, 6*yf[s]:6*yf[s]+6] = b1f[s]
    return SXY, SYAW


def trapz_weights(N: int, K: int) -> np.ndarray:
    """Flat [S] trapezoid weights: 0.5 at each piece's first/last sample
    (alm_traj_opt.cpp:819-827)."""
    w = np.ones((K + 1,), np.float64)
    w[0] = w[-1] = 0.5
    return np.tile(w, N)


@dataclasses.dataclass(frozen=True, eq=False)
class UniformOps:
    """Constant operators of one problem shape, on one device and dtype."""
    gt_xy: torch.Tensor      # [N+5, 6N]        G^T for the xy pieces
    gt_yaw: torch.Tensor     # [Nyaw+5, 6Nyaw]  G^T for the yaw pieces
    sxy_t: torch.Tensor      # [6N, 3S]         SXY^T
    syaw_t: torch.Tensor     # [6Nyaw, 2S]      SYAW^T
    q_xy: torch.Tensor       # [6N, 6N]         jerk block
    q_yaw: torch.Tensor      # [6Nyaw, 6Nyaw]
    trapz: torch.Tensor      # [S]


@functools.lru_cache(maxsize=None)
def uniform_ops(N: int, Nyaw: int, K: int, dtype: torch.dtype,
                device: torch.device) -> UniformOps:
    SXY, SYAW = sample_matrices(N, Nyaw, K)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    return UniformOps(gt_xy=t(_solve_matrix(N).T),
                      gt_yaw=t(_solve_matrix(Nyaw).T),
                      sxy_t=t(SXY.T), syaw_t=t(SYAW.T),
                      q_xy=t(_jerk_q_block(N)), q_yaw=t(_jerk_q_block(Nyaw)),
                      trapz=t(trapz_weights(N, K)))


def generate_norm_cm(inner: torch.Tensor, Tp: torch.Tensor,
                     head: torch.Tensor, tail: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Channel-major normalized coefficients c_norm^T [B, Dim, 6N] of N
    uniform pieces of duration Tp [B] through `inner` [B, N-1, Dim] with
    boundary PVA rows `head`/`tail` [B, 3, Dim]; `gt` is G^T [N+5, 6N]."""
    scale = torch.stack([torch.ones_like(Tp), Tp, Tp * Tp], dim=1)[..., None]
    rT = torch.cat([inner.transpose(1, 2), (head * scale).transpose(1, 2),
                    (tail * scale).transpose(1, 2)], dim=2)   # [B, Dim, N+5]
    return torch.matmul(rT, gt)


@functools.lru_cache(maxsize=None)
def _constants(N: int, dtype: torch.dtype, device: torch.device):
    """(G [6N, N+5], jerk form [6, 6]) of N pieces as tensors."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(_solve_matrix(N)), t(_JERK_Q)


def generate_norm(inner: torch.Tensor, Tp: torch.Tensor, head: torch.Tensor,
                  tail: torch.Tensor, N: int) -> torch.Tensor:
    """Normalized coefficients c_norm [B, N, 6, Dim] of N uniform pieces of
    duration Tp [B] through `inner` [B, N-1, Dim] with boundary PVA rows
    `head`/`tail` [B, 3, Dim] (uniform.py:126-139): `minco.generate(inner,
    full(N, Tp), head, tail)` up to the rescale c[i,k] = c_norm[i,k]/Tp^k."""
    G, _ = _constants(N, inner.dtype, inner.device)
    scale = torch.stack([torch.ones_like(Tp), Tp, Tp * Tp], dim=1)[..., None]
    r = torch.cat([inner, head * scale, tail * scale], dim=1)  # [B, N+5, Dim]
    c = torch.matmul(G, r)                                     # [B, 6N, Dim]
    return c.reshape(c.shape[0], N, 6, -1)


def jerk_cost_norm(c_norm: torch.Tensor, Tp: torch.Tensor,
                   N: int) -> torch.Tensor:
    """Integral of squared jerk [B] over all pieces of c_norm [B, N, 6, Dim]:
    (1/Tp^5) sum_i c_i^T Q c_i (uniform.py:168-175; equals `minco.jerk_cost`
    of the denormalized coefficients, se2traj.hpp:697-710)."""
    _, Q = _constants(N, c_norm.dtype, c_norm.device)
    qc = torch.einsum("kl,bild->bikd", Q, c_norm)
    return torch.sum(qc * c_norm, dim=(1, 2, 3)) / Tp ** 5


def coeffs_from_cm(cT: torch.Tensor, N: int) -> torch.Tensor:
    """[B, Dim, 6N] channel-major -> [B, N, 6, Dim] (generate_norm layout)."""
    B, D = cT.shape[:2]
    return cT.reshape(B, D, N, 6).permute(0, 2, 3, 1)


def denormalize(c_norm: torch.Tensor, Tp: torch.Tensor) -> torch.Tensor:
    """Physical ascending-power coefficients c[b,i,k] = c_norm[b,i,k]/Tp^k
    for c_norm [B, N, 6, Dim]."""
    k = torch.arange(6, dtype=c_norm.dtype, device=c_norm.device)
    return c_norm * (Tp[:, None] ** -k)[:, None, :, None]


def jerk_cost_norm_cm(cT: torch.Tensor, Tp: torch.Tensor,
                      q: torch.Tensor) -> torch.Tensor:
    """Integral of squared jerk [B] from channel-major coefficients cT
    [B, Dim, 6N], as one dense quadratic form with the jerk block q."""
    return torch.sum(torch.matmul(cT, q) * cT, dim=(1, 2)) / Tp ** 5
