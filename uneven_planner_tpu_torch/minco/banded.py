"""Block-tridiagonal linear solver for MINCO systems (port of
`uneven_planner_tpu/minco/banded.py`).

The reference solves its 6N x 6N banded system with an in-place banded LU
without pivoting (banded_system.hpp:14-146).  Here the system is
block-tridiagonal with 6x6 blocks, solved by a block Thomas recursion: a
Python loop over the N pieces, every step a batch of small eliminations
over any leading dimensions (the lanes).  All steps are out-of-place
tensor operations, so autograd differentiates through the solve and takes
the place of the reference's hand-written adjoint
(banded_system.hpp:120-145).
"""

from __future__ import annotations

import torch


def gauss_solve(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense k x k solves [..., k, k] \\ [..., k, m] by Gaussian elimination
    WITHOUT pivoting, unrolled over k, in the elimination order of the JAX
    package's `gauss_solve`.  The no-pivot assumption is the reference's
    (banded_system.hpp:64-66); MINCO diagonal blocks are safely
    conditioned."""
    k = M.shape[-1]
    A = torch.cat([M, B], dim=-1)                       # [..., k, k+m]
    rows = torch.arange(k, device=M.device)
    for i in range(k):
        is_i = rows == i
        row = A[..., i, :] / A[..., i, i:i + 1]
        A = torch.where(is_i[:, None], row[..., None, :], A)
        factors = torch.where(is_i, torch.zeros_like(row[..., :1]),
                              A[..., :, i])
        A = A - factors[..., :, None] * row[..., None, :]
    return A[..., k:]


def block_tridiag_solve(L: torch.Tensor, D: torch.Tensor, U: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Solve block-tridiagonal systems.

    L, D, U: [..., N, k, k] sub-diagonal (L[..., 0, :, :] ignored), diagonal
    and super-diagonal (U[..., N-1, :, :] ignored) blocks; b: [..., N, k, m].
    Returns x [..., N, k, m] with A x = b.  No pivoting beyond the dense
    elimination inside each k x k solve, as in the reference."""
    N, k = D.shape[-3], D.shape[-1]
    W_prev = torch.zeros_like(D[..., 0, :, :])
    y_prev = torch.zeros_like(b[..., 0, :, :])
    Ws, ys = [], []
    for i in range(N):
        Li = L[..., i, :, :]
        M = D[..., i, :, :] - Li @ W_prev
        rhs = torch.cat([U[..., i, :, :], b[..., i, :, :] - Li @ y_prev],
                        dim=-1)
        sol = gauss_solve(M, rhs)
        W_prev, y_prev = sol[..., :k], sol[..., k:]
        Ws.append(W_prev)
        ys.append(y_prev)
    x_next = torch.zeros_like(y_prev)
    xs = [None] * N
    for i in reversed(range(N)):
        x_next = ys[i] - Ws[i] @ x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-3)


def block_tridiag_matvec(L: torch.Tensor, D: torch.Tensor, U: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """A @ x for the same block layout (test utility)."""
    y = D @ x
    lower = L[..., 1:, :, :] @ x[..., :-1, :, :]
    upper = U[..., :-1, :, :] @ x[..., 1:, :, :]
    zero = torch.zeros_like(y[..., :1, :, :])
    return y + torch.cat([zero, lower], dim=-3) \
        + torch.cat([upper, zero], dim=-3)
