"""Limited-memory BFGS with the Lewis-Overton line search (port of
`uneven_planner_tpu/solver/lbfgs.py`), batched over lanes.

The reference is the header-only L-BFGS of lbfgs.hpp:439-723 with the
Lewis-Overton line search of :276-389: fixed-size history, masked two-loop
recursion, cautious updates, the gradient and past-delta tests and the
search's in-search past-delta early accept (lbfgs.hpp:327-329).

`minimize` runs a batch of independent problems in lockstep, as the JAX
package's `vmap(minimize)` does: every iteration and every line-search
evaluation computes all lanes, and a lane that has finished (its search, or
its whole minimization) keeps its state bit for bit while the others go on.
The host reads one lane mask before each lockstep evaluation (`polls`).
The flat solver (`solver/alm.py`) carries its own copy of the iteration and
the search, one evaluation per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

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


def _where(mask, new, old):
    """torch.where with a [B] mask broadcast over old's trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)),
                       new, old)


class _LSState(NamedTuple):
    stp: torch.Tensor       # [B]
    mu: torch.Tensor        # [B] bracket low
    nu: torch.Tensor        # [B] bracket high
    brackt: torch.Tensor    # [B] bool
    touched: torch.Tensor   # [B] bool
    count: torch.Tensor     # [B] evaluations taken
    x: torch.Tensor         # [B, n] last evaluated point
    f: torch.Tensor
    g: torch.Tensor
    status: torch.Tensor    # [B] 0 running, 1 accepted, <0 error


def _line_search(fun, xp, fp, gp, d, stp0, p: LBFGSParams,
                 active: torch.Tensor | None = None):
    """Lewis-Overton line search (lbfgs.hpp:276-389) of every lane of xp
    [B, n] along d from step stp0 [B].  Lanes where `active` is False do
    not search (they return their start with status 1).

    Returns (state, polls): the final _LSState, and the host reads of the
    running mask (one before each lockstep evaluation, and the last)."""
    B = xp.shape[0]
    dginit = _dot(gp, d)
    dgtest = p.f_dec_coeff * dginit
    dstest = p.s_curv_coeff * dginit
    # a non-descent direction is an immediate error (lbfgs.hpp:303-306)
    status = torch.where(dginit > 0.0, ERR_INCREASEGRADIENT, 0)
    if active is not None:
        status = torch.where(active, status, 1)
    false = torch.zeros((B,), dtype=torch.bool, device=xp.device)
    s = _LSState(stp=stp0, mu=torch.zeros_like(fp),
                 nu=torch.full_like(fp, p.max_step), brackt=false,
                 touched=false, count=torch.zeros_like(status),
                 x=xp, f=fp, g=gp, status=status)
    polls = 0
    npast = max(p.past, 1)
    while True:
        running = s.status == 0
        polls += 1
        if not bool(running.any()):
            return s, polls
        x = xp + s.stp[:, None] * d
        f, g = fun(x)
        count = s.count + 1

        # a nonfinite gradient must reject too: NaN Wolfe/Armijo
        # comparisons are False, so a NaN-grad step would otherwise be
        # accepted and poison the L-BFGS memory
        bad_f = ~torch.isfinite(f) | ~torch.isfinite(g).all(-1)
        # in-search past-delta accept (lbfgs.hpp:327-329)
        if p.past > 0:
            early = torch.abs(fp - f) / (torch.abs(fp) + 1.0) \
                < p.delta / npast
        else:
            early = torch.zeros_like(bad_f)
        armijo_fail = f > fp + s.stp * dgtest \
            + p.f_noise_rel * (torch.abs(fp) + 1.0)
        wolfe_fail = _dot(g, d) < dstest
        accepted = ~bad_f & (early | (~armijo_fail & ~wolfe_fail))

        nu = torch.where(armijo_fail, s.stp, s.nu)
        brackt = s.brackt | armijo_fail
        mu = torch.where(~armijo_fail & wolfe_fail, s.stp, s.mu)
        width_small = brackt & ((nu - mu) < p.machine_prec * nu)
        max_ls = count >= p.max_linesearch

        stp_new = torch.where(brackt, 0.5 * (mu + nu), s.stp * 2.0)
        below_min = stp_new < p.min_step
        above_max = stp_new > p.max_step
        stp_next = torch.where(above_max & ~s.touched, p.max_step, stp_new)
        touched = s.touched | above_max

        st = torch.where(bad_f, ERR_INVALIDFUNCVAL, 0)
        st = torch.where((st == 0) & accepted, 1, st)
        st = torch.where((st == 0) & max_ls, ERR_MAXLINESEARCH, st)
        st = torch.where((st == 0) & width_small, ERR_WIDTHTOOSMALL, st)
        st = torch.where((st == 0) & below_min, ERR_MINSTEP, st)
        st = torch.where((st == 0) & above_max & s.touched, ERR_MAXSTEP, st)

        new = _LSState(stp=torch.where(st == 0, stp_next, s.stp), mu=mu,
                       nu=nu, brackt=brackt, touched=touched, count=count,
                       x=x, f=f, g=g, status=st)
        # lanes whose search had ended keep it (vmap's while_loop select)
        s = _LSState(*[_where(running, a, b) for a, b in zip(new, s)])


class LBFGSResult(NamedTuple):
    x: torch.Tensor         # [B, n]
    f: torch.Tensor         # [B]
    g: torch.Tensor         # [B, n]
    status: torch.Tensor    # [B]
    iters: torch.Tensor     # [B]
    evals: torch.Tensor     # [B] evaluations of each lane
    # lockstep evaluations of the batch (the first one included), and host
    # reads of a lane mask
    steps: int = 0
    polls: int = 0


class _State(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    step0: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    YS: torch.Tensor
    end: torch.Tensor
    bound: torch.Tensor
    k: torch.Tensor
    pf: torch.Tensor
    evals: torch.Tensor
    status: torch.Tensor


def minimize(fun: Callable[[torch.Tensor],
                           Tuple[torch.Tensor, torch.Tensor]],
             x0: torch.Tensor, params: LBFGSParams,
             active: torch.Tensor | None = None) -> LBFGSResult:
    """Minimize every lane of fun (x [B, n] -> (f [B], grad [B, n])) from
    x0 [B, n]; each lane as lbfgs_optimize (lbfgs.hpp:439-723) and the JAX
    package's `minimize`: initial step 1/||g||_2, a Lewis-Overton search
    per iteration, convergence when ||g||_inf / max(1, ||x||_inf) <
    g_epsilon or the past-delta test fires.  Lanes where `active` is False
    are not iterated: they return x0 and their first evaluation."""
    p = params
    m = p.mem_size
    B, n = x0.shape
    npast = max(p.past, 1)
    kw = dict(dtype=x0.dtype, device=x0.device)
    lanes = torch.arange(B, device=x0.device)

    f0, g0 = fun(x0)
    gnorm = torch.abs(g0).amax(-1)
    xnorm = torch.abs(x0).amax(-1)
    already = gnorm / torch.clamp(xnorm, min=1.0) < p.g_epsilon
    status = torch.where(already, CONVERGENCE, RUNNING)
    if active is not None:
        status = torch.where(active, status, STOP)
    pf = torch.full((B, npast), float("inf"), **kw)
    pf[:, 0] = f0
    ones = torch.ones((B,), dtype=torch.int64, device=x0.device)
    s = _State(x=x0, f=f0, g=g0,
               step0=1.0 / torch.linalg.vector_norm(g0, dim=-1),
               S=torch.zeros((B, m, n), **kw), Y=torch.zeros((B, m, n), **kw),
               YS=torch.zeros((B, m), **kw), end=0 * ones, bound=0 * ones,
               k=ones, pf=pf, evals=ones, status=status)
    steps, polls = 1, 0
    while True:
        running = s.status == RUNNING
        use_mem = s.bound > 0
        newest = torch.remainder(s.end - 1, m)
        ys = torch.where(use_mem, s.YS[lanes, newest], 1.0)
        yy = torch.where(use_mem, _dot(s.Y[lanes, newest],
                                       s.Y[lanes, newest]), 1.0)
        d_mem = _two_loop(s.g, s.S, s.Y, s.YS, s.end, s.bound, ys, yy, m)
        # nonfinite two-loop output (pathological memory) -> steepest descent
        d = _where(use_mem & torch.isfinite(d_mem).all(-1), d_mem, -s.g)

        # the search's first poll also tells whether any lane still runs
        ls, ls_polls = _line_search(fun, s.x, s.f, s.g, d, s.step0, p,
                                    running)
        polls += ls_polls
        steps += ls_polls - 1
        evals = s.evals + ls.count

        # on line-search error: revert and terminate (lbfgs.hpp:575-582)
        fail = ls.status < 0
        x = _where(fail, s.x, ls.x)
        f = torch.where(fail, s.f, ls.f)
        g = _where(fail, s.g, ls.g)

        conv = torch.abs(g).amax(-1) / torch.clamp(torch.abs(x).amax(-1),
                                                   min=1.0) < p.g_epsilon
        # past-delta stopping (lbfgs.hpp:613-630)
        kmod = torch.remainder(s.k, npast)
        rate = torch.abs(s.pf[lanes, kmod] - f) \
            / torch.clamp(torch.abs(f), min=1.0)
        stop = (s.k >= p.past) & (rate < p.delta) if p.past > 0 \
            else torch.zeros_like(fail)
        pf = s.pf.clone()
        pf[lanes, kmod] = f
        maxit = s.k >= p.max_iterations if p.max_iterations > 0 \
            else torch.zeros_like(fail)

        st = torch.where(fail, ls.status, RUNNING)
        st = torch.where((st == RUNNING) & conv, CONVERGENCE, st)
        st = torch.where((st == RUNNING) & stop, STOP, st)
        st = torch.where((st == RUNNING) & maxit, MAXITER, st)

        # memory update with the cautious condition (lbfgs.hpp:647-677) and
        # the relative curvature floor that keeps a ~0 ys out of the memory
        s_vec = x - s.x
        y_vec = g - s.g
        ys_new = _dot(y_vec, s_vec)
        ss = _dot(s_vec, s_vec)
        cau = ss * torch.linalg.vector_norm(s.g, dim=-1) * p.cautious_factor
        ys_floor = 1e-10 * torch.sqrt(ss * _dot(y_vec, y_vec))
        accept = (ys_new > torch.maximum(cau, ys_floor)) & ~fail
        S, Y, YS = s.S.clone(), s.Y.clone(), s.YS.clone()
        S[lanes, s.end] = s_vec
        Y[lanes, s.end] = y_vec
        YS[lanes, s.end] = ys_new
        new = _State(
            x=x, f=f, g=g, step0=torch.ones_like(s.step0),
            S=_where(accept, S, s.S), Y=_where(accept, Y, s.Y),
            YS=_where(accept, YS, s.YS),
            end=torch.where(accept, torch.remainder(s.end + 1, m), s.end),
            bound=torch.where(accept, torch.clamp(s.bound + 1, max=m),
                              s.bound),
            k=s.k + 1, pf=pf, evals=evals, status=st)
        # finished lanes keep their state (vmap's while_loop select)
        s = _State(*[_where(running, a, b) for a, b in zip(new, s)])
        # no evaluation: every lane that ran met a non-descent direction
        # and has stopped, so none runs any more
        if ls_polls == 1:
            break
    return LBFGSResult(x=s.x, f=s.f, g=s.g, status=s.status, iters=s.k - 1,
                       evals=s.evals, steps=steps, polls=polls)
