"""L-BFGS pieces of the flat solver (port of `uneven_planner_tpu/solver/
lbfgs.py`: parameters, status codes and the two-loop recursion, batched
over lanes).

The reference is the header-only L-BFGS of lbfgs.hpp:439-723 with the
Lewis-Overton line search of :276-389; the flat solver (`solver/alm.py`)
carries the iteration and the line search itself.
"""

from __future__ import annotations

import dataclasses

import torch

# Status codes (positive = terminated normally, negative = error), as the
# reference's enum (lbfgs.hpp:135-184).
RUNNING = 0
CONVERGENCE = 1
STOP = 2
MAXITER = 3
ERR_MAXLINESEARCH = -1
ERR_MINSTEP = -2
ERR_MAXSTEP = -3
ERR_WIDTHTOOSMALL = -4
ERR_INCREASEGRADIENT = -5
ERR_INVALIDFUNCVAL = -6


@dataclasses.dataclass(frozen=True)
class LBFGSParams:
    mem_size: int = 16
    g_epsilon: float = 1.0e-5
    past: int = 3
    delta: float = 1.0e-6
    max_iterations: int = 64
    max_linesearch: int = 64
    min_step: float = 1.0e-20
    max_step: float = 1.0e20
    f_dec_coeff: float = 1.0e-4
    s_curv_coeff: float = 0.9
    cautious_factor: float = 1.0e-6
    machine_prec: float = 1.0e-16
    # Noise-tolerant Armijo slack: accept f_t <= f + stp*dgtest +
    # f_noise_rel*(|f|+1); 0.0 is the exact Lewis-Overton test
    # (lbfgs.hpp:321).
    f_noise_rel: float = 0.0


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _two_loop(g, S, Y, YS, end, bound, ys, yy, m: int):
    """Masked two-loop recursion (lbfgs.hpp:687-710), batched: g [B, n],
    S/Y [B, m, n], YS [B, m], end/bound [B] int, ys/yy [B] -> d [B, n]."""
    lanes = torch.arange(g.shape[0], device=g.device)
    d = -g
    alpha = torch.zeros(YS.shape, dtype=g.dtype, device=g.device)
    for i in range(m):
        j = torch.remainder(end - 1 - i, m)
        valid = i < bound
        denom = torch.where(valid, YS[lanes, j], 1.0)
        a = torch.where(valid, _dot(S[lanes, j], d) / denom, 0.0)
        d = d - a[:, None] * Y[lanes, j]
        alpha[lanes, j] = a
    d = d * (ys / yy)[:, None]
    for i in range(m):
        j = torch.remainder(end - bound + i, m)
        valid = i < bound
        denom = torch.where(valid, YS[lanes, j], 1.0)
        b = torch.where(valid, _dot(Y[lanes, j], d) / denom, 0.0)
        d = d + torch.where(valid, alpha[lanes, j] - b, 0.0)[:, None] \
            * S[lanes, j]
    return d
