"""PHR Augmented-Lagrangian MINCO trajectory optimizer (port of
`uneven_planner_tpu/solver/alm.py`: the flat solver and its compacted batch
solve).

Every function works on a batch of independent lanes: the decision vectors
x [B, n], boundaries [B, 3, Dim], duals [B, E] / [B, I] / [B] and scalings
[B] / [B, 7, S].  Where the JAX package used `vmap`, the batch is written
out; where it used `value_and_grad`, the port differentiates the sum over
lanes, which equals the per-lane gradients because lanes do not interact.

Decision vector x = [tau, inner_xy (Nxy-1 x 2 flattened), inner_yaw
(Nyaw-1)], with one log-time tau giving uniform piece times
T_piece = expC2(tau)/N (alm_traj_opt.h:232-261).  The inner objective
(alm_traj_opt.cpp:280-347, :663-991) is one differentiable sampling pass:
constant MINCO matmuls, the terrain lookup (a CUDA kernel on the GPU), and
the PHR penalties.  The ALM outer loop, L-BFGS and the Lewis-Overton line
search are flattened into one loop whose step performs exactly one cost and
gradient evaluation per lane; finished lanes keep their state.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

from uneven_planner_tpu_torch.config import ALMConfig
from uneven_planner_tpu_torch.minco import uniform
from uneven_planner_tpu_torch.minco.traj import SE2Traj
from uneven_planner_tpu_torch.solver import lbfgs
from uneven_planner_tpu_torch.terrain import grid as tgrid


# ---------------------------------------------------------------------------
# tau <-> T maps (alm_traj_opt.h:232-261)
# ---------------------------------------------------------------------------

def expC2(tau):
    """T = e^tau via the C2 rational surrogate."""
    pos = (0.5 * tau + 1.0) * tau + 1.0
    neg = 1.0 / ((0.5 * tau - 1.0) * tau + 1.0)
    return torch.where(tau > 0.0, pos, neg)


def logC2(T):
    """tau = ln(T) inverse of expC2."""
    big = torch.sqrt(torch.clamp(2.0 * T - 1.0, min=0.0)) - 1.0
    small = 1.0 - torch.sqrt(torch.clamp(
        2.0 / torch.clamp(T, min=1e-12) - 1.0, min=0.0))
    return torch.where(T > 1.0, big, small)


# ---------------------------------------------------------------------------
# Problem spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProblemShape:
    piece_xy: int
    piece_yaw: int
    int_K: int

    @property
    def num_vars(self):
        return 1 + 2 * (self.piece_xy - 1) + (self.piece_yaw - 1)

    @property
    def equal_num(self):
        return self.piece_xy * (self.int_K + 1)

    @property
    def non_equal_num(self):
        return 6 * self.equal_num


class Boundary(NamedTuple):
    """Boundary PVA states per lane: rows (pos; vel; acc)."""
    head_xy: torch.Tensor   # [B, 3, 2]
    tail_xy: torch.Tensor   # [B, 3, 2]
    head_yaw: torch.Tensor  # [B, 3, 1]
    tail_yaw: torch.Tensor  # [B, 3, 1]


class DualState(NamedTuple):
    lam: torch.Tensor       # [B, E] equality multipliers
    mu: torch.Tensor        # [B, I] inequality multipliers
    rho: torch.Tensor       # [B] penalty


class Scaling(NamedTuple):
    scale_fx: torch.Tensor  # [B]
    scale_cx: torch.Tensor  # [B, 7, S] channel-major per-constraint scale


def tree_map(fn, *trees):
    """Apply `fn` leafwise over NamedTuples of tensors (None stays None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*[tree_map(fn, *parts) for parts in zip(*trees)])
    return fn(*trees)


def unpack(x, shape: ProblemShape):
    nxy, nyaw = shape.piece_xy, shape.piece_yaw
    B = x.shape[0]
    tau = x[:, 0]
    pxy = x[:, 1:1 + 2 * (nxy - 1)].reshape(B, nxy - 1, 2)
    pyaw = x[:, 1 + 2 * (nxy - 1):].reshape(B, nyaw - 1, 1)
    return tau, pxy, pyaw


def pack(tau, pxy, pyaw):
    B = tau.shape[0]
    return torch.cat([tau[:, None], pxy.reshape(B, -1), pyaw.reshape(B, -1)],
                     dim=1)


def _ops(shape: ProblemShape, x) -> uniform.UniformOps:
    return uniform.uniform_ops(shape.piece_xy, shape.piece_yaw, shape.int_K,
                               x.dtype, x.device)


def _coeffs_norm_cm(x, bound: Boundary, shape: ProblemShape):
    """Channel-major normalized coefficients ([B, Dim, 6N])."""
    tau, pxy, pyaw = unpack(x, shape)
    ops = _ops(shape, x)
    T = expC2(tau)
    Tp_xy = T / shape.piece_xy
    Tp_yaw = T / shape.piece_yaw
    cT_xy = uniform.generate_norm_cm(pxy, Tp_xy, bound.head_xy,
                                     bound.tail_xy, ops.gt_xy)
    cT_yaw = uniform.generate_norm_cm(pyaw, Tp_yaw, bound.head_yaw,
                                      bound.tail_yaw, ops.gt_yaw)
    return cT_xy, Tp_xy, cT_yaw, Tp_yaw, T


def _coeffs(x, bound: Boundary, shape: ProblemShape):
    """Physical coefficients [B, N, 6, Dim] + piece-time vectors [B, N]."""
    cT_xy, Tp_xy, cT_yaw, Tp_yaw, T = _coeffs_norm_cm(x, bound, shape)
    c_xy = uniform.denormalize(
        uniform.coeffs_from_cm(cT_xy, shape.piece_xy), Tp_xy)
    c_yaw = uniform.denormalize(
        uniform.coeffs_from_cm(cT_yaw, shape.piece_yaw), Tp_yaw)
    B = x.shape[0]
    ts_xy = Tp_xy[:, None].expand(B, shape.piece_xy).contiguous()
    ts_yaw = Tp_yaw[:, None].expand(B, shape.piece_yaw).contiguous()
    return c_xy, ts_xy, c_yaw, ts_yaw, T


class SampleValues(NamedTuple):
    """Per-sample physical quantities over the flat S = Nxy*(K+1) grid."""
    pos: torch.Tensor       # [B, 2, S]
    vel: torch.Tensor       # [B, 2, S]
    acc: torch.Tensor       # [B, 2, S]
    yaw: torch.Tensor       # [B, S]
    dyaw: torch.Tensor
    vx: torch.Tensor        # body-frame forward speed (terrain-corrected)
    ax: torch.Tensor        # longitudinal acceleration incl. gravity
    ay: torch.Tensor        # lateral acceleration incl. gravity
    curv_snorm: torch.Tensor
    cos_xi: torch.Tensor
    sigma: torch.Tensor
    nonh: torch.Tensor      # v . (sin yaw, -cos yaw)


def _sample_kernel(x, bound: Boundary, shape: ProblemShape,
                   grid: tgrid.TerrainGrid, cfg: ALMConfig,
                   exact: bool = True):
    """All constraint sample quantities (alm_traj_opt.cpp:710-817).
    exact=False takes the f16 packed lookup when the grid carries it."""
    S = shape.equal_num
    ops = _ops(shape, x)
    cT_xy, Tp_xy, cT_yaw, Tp_yaw, T = _coeffs_norm_cm(x, bound, shape)

    sxy = torch.matmul(cT_xy, ops.sxy_t)                   # [B, 2, 3S]
    pos = sxy[:, :, :S]
    vel = sxy[:, :, S:2 * S] / Tp_xy[:, None, None]
    acc = sxy[:, :, 2 * S:] / (Tp_xy * Tp_xy)[:, None, None]
    syaw2 = torch.matmul(cT_yaw, ops.syaw_t)[:, 0]         # [B, 2S]
    yaw = syaw2[:, :S]
    dyaw = syaw2[:, S:] / Tp_yaw[:, None]

    tv = tgrid.get_terrain_variables_cm(grid, pos[:, 0], pos[:, 1],
                                        tgrid.normalize_so2(yaw),
                                        exact=exact)       # [7, B, S]
    inv_cos_vphix, sin_phix = tv[0], tv[1]
    inv_cos_vphiy, sin_phiy = tv[2], tv[3]
    cos_xi, inv_cos_xi, sigma = tv[4], tv[5], tv[6]

    cyaw_, syaw_ = torch.cos(yaw), torch.sin(yaw)
    # floor under the norm: d(sqrt)/dx at exactly 0 is NaN
    v_norm = torch.sqrt(torch.clamp(vel[:, 0] * vel[:, 0]
                                    + vel[:, 1] * vel[:, 1], min=1e-24))
    lon_acc = acc[:, 0] * cyaw_ + acc[:, 1] * syaw_
    lat_acc = -acc[:, 0] * syaw_ + acc[:, 1] * cyaw_
    g = grid.gravity

    vx = v_norm * inv_cos_vphix
    wz = dyaw * inv_cos_xi
    ax = lon_acc * inv_cos_vphix + g * sin_phix
    ay = lat_acc * inv_cos_vphiy + g * sin_phiy
    curv_snorm = wz * wz / (vx * vx + cfg.delta_sigl)
    nonh = vel[:, 0] * syaw_ - vel[:, 1] * cyaw_

    return SampleValues(pos=pos, vel=vel, acc=acc, yaw=yaw, dyaw=dyaw,
                        vx=vx, ax=ax, ay=ay, curv_snorm=curv_snorm,
                        cos_xi=cos_xi, sigma=sigma, nonh=nonh), \
        (cT_xy, Tp_xy, cT_yaw, Tp_yaw, T)


def _inequalities(sv: SampleValues, cfg: ALMConfig):
    """[B, 6, S] unscaled inequalities in the reference ordering {vel,
    acc_lon, acc_lat, curv, att, sigma} (alm_traj_opt.cpp:829-946)."""
    return torch.stack([
        sv.vx ** 2 - cfg.max_vel ** 2,
        sv.ax ** 2 - cfg.max_acc_lon ** 2,
        sv.ay ** 2 - cfg.max_acc_lat ** 2,
        sv.curv_snorm - cfg.max_kap ** 2,
        cfg.min_cxi - sv.cos_xi,
        sv.sigma - cfg.max_sig,
    ], dim=1)


def raw_constraints(x, bound, shape, grid, cfg):
    """Unscaled h [B, S] and g [B, 6, S] on the exact terrain path."""
    sv, _ = _sample_kernel(x, bound, shape, grid, cfg)
    return sv.nonh, _inequalities(sv, cfg)


def default_scale_cx(shape: ProblemShape, cfg: ALMConfig, B: int, dtype,
                     device):
    """Constraint scaling when use_scaling is off: 1 except the fixed
    cur_scale / sig_scale rows (alm_traj_opt.cpp:891-893,929-932)."""
    sc = torch.ones((B, 7, shape.equal_num), dtype=dtype, device=device)
    sc[:, 4] = cfg.cur_scale
    sc[:, 6] = cfg.sig_scale
    return sc


def _jerk(cT_xy, Tp_xy, cT_yaw, Tp_yaw, shape, x):
    ops = _ops(shape, x)
    return uniform.jerk_cost_norm_cm(cT_xy, Tp_xy, ops.q_xy) \
        + uniform.jerk_cost_norm_cm(cT_yaw, Tp_yaw, ops.q_yaw)


def smooth_cost(x, bound, shape, grid, cfg, scale_fx):
    """(jerk [B], (sigma^2 running cost + rho_T * T) * scale_fx [B]): the
    'fx' of initScaling (alm_traj_opt.cpp:365-370,507-519,633-636)."""
    sv, (cT_xy, Tp_xy, cT_yaw, Tp_yaw, T) = _sample_kernel(
        x, bound, shape, grid, cfg)
    jerk = _jerk(cT_xy, Tp_xy, cT_yaw, Tp_yaw, shape, x)
    step = Tp_xy / shape.int_K
    w = _ops(shape, x).trapz
    user = cfg.rho_ter * step * torch.sum(w * sv.sigma ** 2, dim=-1)
    time_cost = cfg.rho_T * T
    return jerk, (user + time_cost) * scale_fx


def inner_cost_aux(x, bound, shape, grid, cfg, duals: DualState,
                   scaling: Scaling, exact: bool = True):
    """The L-BFGS objective (innerCallback, alm_traj_opt.cpp:280-347) per
    lane, with the scaled constraints it evaluated: (cost [B], (h [B, E],
    g [B, I]))."""
    sv, (cT_xy, Tp_xy, cT_yaw, Tp_yaw, T) = _sample_kernel(
        x, bound, shape, grid, cfg, exact)
    B = x.shape[0]
    trick = cfg.scale_trick_jerk if cfg.use_scaling else 1.0
    jerk = _jerk(cT_xy, Tp_xy, cT_yaw, Tp_yaw, shape, x) \
        * scaling.scale_fx * trick

    step = Tp_xy / shape.int_K
    w = _ops(shape, x).trapz
    user = cfg.rho_ter * step * scaling.scale_fx * \
        torch.sum(w * sv.sigma ** 2, dim=-1)

    rho = duals.rho[:, None]
    sc = scaling.scale_cx                                   # [B, 7, S]

    # equality (non-holonomic): PHR term h(lam + 0.5 rho h)
    h = sv.nonh * sc[:, 0]
    cost_h = torch.sum(h * (duals.lam + 0.5 * rho * h), dim=-1)

    # inequalities with active-set branch (alm_traj_opt.cpp:840-946)
    g = (_inequalities(sv, cfg) * sc[:, 1:7]).reshape(B, -1)
    mu = duals.mu
    active = rho * g + mu > 0
    cost_g = torch.sum(torch.where(active, g * (mu + 0.5 * rho * g),
                                   -0.5 * mu * mu / rho), dim=-1)

    time_cost = cfg.rho_T * T * scaling.scale_fx
    return jerk + user + cost_h + cost_g + time_cost, (h, g)


# ---------------------------------------------------------------------------
# initScaling (alm_traj_opt.cpp:349-661)
# ---------------------------------------------------------------------------

def _repeat_lanes(tree, n: int):
    return tree_map(lambda a: a.repeat_interleave(n, dim=0), tree)


# lanes per forward-mode pass of init_scaling: 1024 x 38 tangents x 90
# samples keeps the pass near 3.5 M lookups (a few GB of intermediates)
JAC_LANES = 1024


def init_scaling(x0, bound, shape, grid, cfg) -> Scaling:
    """scale_fx = 1/max(1, ||grad fx(x0)||_inf); per-constraint
    scale_cx[k] = 1/max(1, ||grad c_k(x0)||_inf).

    The constraint Jacobian (jax.jacfwd in the JAX package) is one
    forward-mode pass over the lanes repeated num_vars times with identity
    tangents, JAC_LANES lanes at a time."""
    B, n = x0.shape
    x = x0.detach().requires_grad_(True)
    with torch.enable_grad():
        jerk, rest = smooth_cost(x, bound, shape, grid, cfg,
                                 torch.ones((), dtype=x.dtype,
                                            device=x.device))
        gfx, = torch.autograd.grad((jerk + rest).sum(), x)
    scale_fx = 1.0 / torch.clamp(gfx.abs().amax(-1), min=1.0)

    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    norms = []
    for lo in range(0, B, JAC_LANES):
        xb = x0[lo:lo + JAC_LANES].detach()
        b = xb.shape[0]
        bb = _repeat_lanes(tree_map(lambda a: a[lo:lo + b], bound), n)
        with torch.no_grad(), fwAD.dual_level():
            xd = fwAD.make_dual(xb.repeat_interleave(n, dim=0),
                                eye.repeat(b, 1))
            h, g = raw_constraints(xd, bb, shape, grid, cfg)
            cons = torch.cat([h[:, None, :], g], dim=1).reshape(b * n, -1)
            jt = fwAD.unpack_dual(cons).tangent           # [b*n, 7S]
        norms.append(jt.reshape(b, n, -1).abs().amax(1))
    norms = torch.cat(norms)
    scale_cx = (1.0 / torch.clamp(norms, min=1.0)).reshape(
        B, 7, shape.equal_num)
    return Scaling(scale_fx=scale_fx, scale_cx=scale_cx)


def _make_scaling(x0, bound, shape, grid, cfg) -> Scaling:
    if cfg.use_scaling:
        return init_scaling(x0, bound, shape, grid, cfg)
    B = x0.shape[0]
    return Scaling(
        scale_fx=torch.ones((B,), dtype=x0.dtype, device=x0.device),
        scale_cx=default_scale_cx(shape, cfg, B, x0.dtype, x0.device))


# ---------------------------------------------------------------------------
# Flattened single-loop solver
# ---------------------------------------------------------------------------

class ALMResult(NamedTuple):
    x: torch.Tensor
    traj: SE2Traj
    converged: torch.Tensor
    outer_iters: torch.Tensor
    inner_iters: torch.Tensor
    res_h: torch.Tensor
    res_g: torch.Tensor
    lbfgs_status: torch.Tensor
    # cost+gradient evaluations per lane
    evals: torch.Tensor | None = None
    # final multipliers/penalty per lane (return_duals=True)
    duals: DualState | None = None
    # batched solver steps the call ran (each one terrain-kernel launch)
    steps: int = 0


def lbfgs_params_from(cfg: ALMConfig) -> lbfgs.LBFGSParams:
    return lbfgs.LBFGSParams(
        mem_size=cfg.mem_size, g_epsilon=cfg.g_epsilon, past=cfg.past,
        delta=cfg.delta, max_iterations=int(cfg.inner_max_iter),
        max_linesearch=cfg.max_linesearch, min_step=cfg.min_step,
        f_dec_coeff=cfg.f_dec_coeff, s_curv_coeff=cfg.s_curv_coeff,
        cautious_factor=cfg.cautious_factor, machine_prec=cfg.machine_prec,
        f_noise_rel=cfg.f_noise_rel)


def _params(cfg: ALMConfig, lbfgs_overrides: dict | None):
    p = lbfgs_params_from(cfg)
    if lbfgs_overrides:
        p = dataclasses.replace(p, **lbfgs_overrides)
    return p


class _FlatState(NamedTuple):
    # current accepted iterate (+ its scaled constraints, cached for duals)
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    h: torch.Tensor          # [B, E] scaled equality at x
    gc: torch.Tensor         # [B, I] scaled inequality at x
    # L-BFGS memory
    S: torch.Tensor
    Y: torch.Tensor
    YS: torch.Tensor
    end: torch.Tensor
    bound: torch.Tensor
    k: torch.Tensor
    pf: torch.Tensor
    # line search (Lewis-Overton bracket)
    d: torch.Tensor
    stp: torch.Tensor
    ls_lo: torch.Tensor
    ls_hi: torch.Tensor
    brackt: torch.Tensor
    touched: torch.Tensor
    ls_count: torch.Tensor
    dgtest: torch.Tensor
    dstest: torch.Tensor
    # ALM outer
    duals: DualState
    o_it: torch.Tensor
    res_h: torch.Tensor
    res_g: torch.Tensor
    lb_status: torch.Tensor
    # control
    reeval: torch.Tensor     # next eval (re)starts L-BFGS under current duals
    done: torch.Tensor
    evals: torch.Tensor
    inner_iters: torch.Tensor


def _broadcast_warm_duals(warm_duals: DualState, B: int) -> DualState:
    """Accept one prior DualState ([E]/[I]/scalar) or a per-lane batch
    ([B,E]/[B,I]/[B]) and return the batched form."""
    if warm_duals.lam.dim() == 1:
        return DualState(lam=warm_duals.lam.expand(B, -1),
                         mu=warm_duals.mu.expand(B, -1),
                         rho=warm_duals.rho.reshape(()).expand(B))
    return warm_duals


def flat_init(x0, shape: ProblemShape, cfg: ALMConfig, p: lbfgs.LBFGSParams,
              warm_duals: DualState | None = None) -> _FlatState:
    B, n = x0.shape
    kw = dict(dtype=x0.dtype, device=x0.device)
    ik = dict(dtype=torch.int64, device=x0.device)
    E, I = shape.equal_num, shape.non_equal_num
    m = p.mem_size
    npast = max(p.past, 1)
    if warm_duals is None:
        duals0 = DualState(lam=torch.zeros((B, E), **kw),
                           mu=torch.zeros((B, I), **kw),
                           rho=torch.full((B,), cfg.rho, **kw))
    else:
        duals0 = tree_map(lambda a: a.to(**kw).contiguous(),
                          _broadcast_warm_duals(warm_duals, B))
    zeros = lambda *s: torch.zeros((B,) + s, **kw)
    false = torch.zeros((B,), dtype=torch.bool, device=x0.device)
    return _FlatState(
        x=x0, f=torch.full((B,), float("inf"), **kw), g=zeros(n),
        h=zeros(E), gc=zeros(I),
        S=zeros(m, n), Y=zeros(m, n), YS=zeros(m),
        end=torch.zeros((B,), **ik), bound=torch.zeros((B,), **ik),
        k=torch.ones((B,), **ik),
        pf=torch.full((B, npast), float("inf"), **kw),
        d=zeros(n), stp=zeros(), ls_lo=zeros(),
        ls_hi=torch.full((B,), p.max_step, **kw),
        brackt=false, touched=false.clone(),
        ls_count=torch.zeros((B,), **ik),
        dgtest=zeros(), dstest=zeros(),
        duals=duals0,
        o_it=torch.zeros((B,), **ik),
        res_h=torch.full((B,), float("inf"), **kw),
        res_g=torch.full((B,), float("inf"), **kw),
        lb_status=torch.zeros((B,), **ik),
        reeval=torch.ones((B,), dtype=torch.bool, device=x0.device),
        done=false.clone(),
        evals=torch.zeros((B,), **ik),
        inner_iters=torch.zeros((B,), **ik))


def _lanes(mask, like):
    """[B] mask viewed to broadcast against a [B, ...] tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _where(mask, new, old):
    return torch.where(_lanes(mask, old), new, old)


def flat_step(s: _FlatState, bound: Boundary, scaling: Scaling,
              shape: ProblemShape, grid, cfg: ALMConfig,
              p: lbfgs.LBFGSParams) -> _FlatState:
    """One flat-solver step for every lane: exactly one cost+grad evaluation
    plus masked line-search / L-BFGS / ALM bookkeeping (alm.py:618-794).
    The caller keeps finished lanes' state (`flat_run`)."""
    m = p.mem_size
    npast = max(p.past, 1)
    B = s.x.shape[0]
    lanes = torch.arange(B, device=s.x.device)

    x_t = s.x + s.stp[:, None] * s.d
    with torch.enable_grad():
        xg = x_t.detach().requires_grad_(True)
        f_t, (h_t, g_t) = inner_cost_aux(xg, bound, shape, grid, cfg,
                                         s.duals, scaling, False)
        grad_t, = torch.autograd.grad(f_t.sum(), xg)
    f_t, h_t, g_t = f_t.detach(), h_t.detach(), g_t.detach()
    rv = s.reeval

    # ---- line-search decision (lbfgs.hpp:276-389), masked by ~reeval; a
    # nonfinite gradient must also reject the step (NaN comparisons are
    # False, so a NaN-grad step would otherwise be accepted)
    bad = ~torch.isfinite(f_t) | ~torch.isfinite(grad_t).all(-1)
    if p.past > 0:
        early = torch.abs(s.f - f_t) / (torch.abs(s.f) + 1.0) \
            < p.delta / npast
    else:
        early = torch.zeros_like(bad)
    armijo_fail = f_t > s.f + s.stp * s.dgtest \
        + p.f_noise_rel * (torch.abs(s.f) + 1.0)
    dg = lbfgs._dot(grad_t, s.d)
    wolfe_fail = dg < s.dstest
    accepted = ~rv & ~bad & (early | (~armijo_fail & ~wolfe_fail))

    ls_hi_n = torch.where(armijo_fail, s.stp, s.ls_hi)
    brackt_n = s.brackt | armijo_fail
    ls_lo_n = torch.where(~armijo_fail & wolfe_fail, s.stp, s.ls_lo)
    width_small = brackt_n & ((ls_hi_n - ls_lo_n)
                              < p.machine_prec * ls_hi_n)
    count = s.ls_count + 1
    max_ls = count >= p.max_linesearch
    stp_new = torch.where(brackt_n, 0.5 * (ls_lo_n + ls_hi_n), s.stp * 2.0)
    below_min = stp_new < p.min_step
    above_max = stp_new > p.max_step
    stp_cont = torch.where(above_max & ~s.touched, p.max_step, stp_new)
    touched_n = s.touched | above_max

    ls_err = torch.where(bad, lbfgs.ERR_INVALIDFUNCVAL, 0)
    ls_err = torch.where((ls_err == 0) & max_ls, lbfgs.ERR_MAXLINESEARCH,
                         ls_err)
    ls_err = torch.where((ls_err == 0) & width_small,
                         lbfgs.ERR_WIDTHTOOSMALL, ls_err)
    ls_err = torch.where((ls_err == 0) & below_min, lbfgs.ERR_MINSTEP,
                         ls_err)
    ls_err = torch.where((ls_err == 0) & above_max & s.touched,
                         lbfgs.ERR_MAXSTEP, ls_err)
    ls_fail = ~rv & ~accepted & (ls_err < 0)
    step_done = accepted | ls_fail          # one L-BFGS iteration ends

    # ---- iterate update (accept / revert / fresh-start)
    take_new = accepted | rv
    x_n = _where(take_new, x_t, s.x)
    f_n = _where(take_new, f_t, s.f)
    g_n = _where(take_new, grad_t, s.g)
    h_n = _where(take_new, h_t, s.h)
    gc_n = _where(take_new, g_t, s.gc)

    # ---- L-BFGS iteration bookkeeping (lbfgs.hpp:585-677)
    gnorm = torch.abs(g_n).amax(-1)
    xnorm = torch.abs(x_n).amax(-1)
    conv = gnorm / torch.clamp(xnorm, min=1.0) < p.g_epsilon
    kmod = torch.remainder(s.k, npast)
    rate = torch.abs(s.pf[lanes, kmod] - f_n) \
        / torch.clamp(torch.abs(f_n), min=1.0)
    stop = (s.k >= p.past) & (rate < p.delta) & ~rv if p.past > 0 \
        else torch.zeros_like(rv)
    maxit = (s.k >= p.max_iterations) & ~rv if p.max_iterations > 0 \
        else torch.zeros_like(rv)

    status = torch.where(ls_fail, ls_err, lbfgs.RUNNING)
    status = torch.where((status == 0) & conv, lbfgs.CONVERGENCE, status)
    status = torch.where((status == 0) & stop, lbfgs.STOP, status)
    status = torch.where((status == 0) & maxit, lbfgs.MAXITER, status)
    # fresh start: only immediate convergence terminates (lbfgs.hpp:497)
    status = torch.where(rv, torch.where(conv, lbfgs.CONVERGENCE,
                                         lbfgs.RUNNING), status)
    lb_done = (step_done | rv) & (status != lbfgs.RUNNING)

    pf_rv = torch.full_like(s.pf, float("inf"))
    pf_rv[:, 0] = f_t
    pf_step = s.pf.clone()
    pf_step[lanes, kmod] = f_n
    pf_n = _where(rv, pf_rv, _where(step_done, pf_step, s.pf))

    # cautious memory update (only on a real accepted step), with the
    # relative curvature floor that keeps a ~0 ys out of the memory
    s_vec = x_t - s.x
    y_vec = grad_t - s.g
    ys_new = lbfgs._dot(y_vec, s_vec)
    ss = lbfgs._dot(s_vec, s_vec)
    cau = ss * torch.linalg.vector_norm(s.g, dim=-1) * p.cautious_factor
    ys_floor = 1e-10 * torch.sqrt(ss * lbfgs._dot(y_vec, y_vec))
    acc_mem = accepted & (ys_new > torch.maximum(cau, ys_floor))
    S_set, Y_set, YS_set = s.S.clone(), s.Y.clone(), s.YS.clone()
    S_set[lanes, s.end] = s_vec
    Y_set[lanes, s.end] = y_vec
    YS_set[lanes, s.end] = ys_new
    S_n = _where(rv, torch.zeros_like(s.S), _where(acc_mem, S_set, s.S))
    Y_n = _where(rv, torch.zeros_like(s.Y), _where(acc_mem, Y_set, s.Y))
    YS_n = _where(rv, torch.zeros_like(s.YS),
                  _where(acc_mem, YS_set, s.YS))
    zero = torch.zeros_like(s.end)
    end_n = torch.where(rv, zero, torch.where(
        acc_mem, torch.remainder(s.end + 1, m), s.end))
    bound_n = torch.where(rv, zero, torch.where(
        acc_mem, torch.clamp(s.bound + 1, max=m), s.bound))
    k_n = torch.where(rv, 1, torch.where(step_done, s.k + 1, s.k))
    inner_n = s.inner_iters + step_done.to(s.inner_iters.dtype)

    # ---- new search direction when an iteration (or fresh start) ends
    newest = torch.remainder(end_n - 1, m)
    use_mem = bound_n > 0
    ys0 = torch.where(use_mem, YS_n[lanes, newest], 1.0)
    yy0 = torch.where(use_mem, lbfgs._dot(Y_n[lanes, newest],
                                          Y_n[lanes, newest]), 1.0)
    d_mem = lbfgs._two_loop(g_n, S_n, Y_n, YS_n, end_n, bound_n, ys0, yy0, m)
    # nonfinite two-loop output (pathological memory) -> steepest descent
    d_new = _where(use_mem & torch.isfinite(d_mem).all(-1), d_mem, -g_n)
    dginit = lbfgs._dot(g_n, d_new)
    # non-descent direction is an immediate L-BFGS error
    bad_dir = (step_done | rv) & ~lb_done & (dginit > 0.0)
    status = torch.where(bad_dir, lbfgs.ERR_INCREASEGRADIENT, status)
    lb_done = lb_done | bad_dir

    # ---- ALM outer round completion (dual update, alm_traj_opt.h:132-151)
    rho = s.duals.rho
    lam_u = s.duals.lam + rho[:, None] * h_n
    mu_u = torch.clamp(s.duals.mu + rho[:, None] * gc_n, min=0.0)
    rho_u = torch.clamp((1.0 + cfg.gamma) * rho, max=cfg.beta)
    res_h_u = torch.abs(h_n).amax(-1)
    res_g_u = torch.maximum(gc_n, -mu_u / rho_u[:, None]).amax(-1)
    conv_outer = torch.maximum(res_h_u, res_g_u) < cfg.epsilon_con
    o_it_u = s.o_it + 1
    done_u = conv_outer | (o_it_u > cfg.max_iter)

    sel = lambda new, old: _where(lb_done, new, old)
    duals_n = DualState(lam=sel(lam_u, s.duals.lam),
                        mu=sel(mu_u, s.duals.mu),
                        rho=sel(rho_u, s.duals.rho))
    done_n = lb_done & done_u
    reeval_n = lb_done & ~done_u

    # ---- next line-search state
    fresh = (step_done | rv) & ~lb_done
    stp_fresh = torch.where(rv, 1.0 / torch.clamp(
        torch.linalg.vector_norm(d_new, dim=-1), min=p.machine_prec), 1.0)
    d_n = _where(fresh, d_new, s.d)
    stp_n = torch.where(reeval_n, 0.0,
                        torch.where(fresh, stp_fresh, stp_cont))
    dg_n = torch.where(fresh, dginit, 0.0)
    d_n = _where(reeval_n, torch.zeros_like(d_n), d_n)

    return _FlatState(
        x=x_n, f=f_n, g=g_n, h=h_n, gc=gc_n,
        S=S_n, Y=Y_n, YS=YS_n, end=end_n, bound=bound_n, k=k_n,
        pf=pf_n, d=d_n, stp=stp_n,
        ls_lo=torch.where(fresh, 0.0, ls_lo_n),
        ls_hi=torch.where(fresh, p.max_step, ls_hi_n),
        brackt=brackt_n & ~fresh, touched=touched_n & ~fresh,
        ls_count=torch.where(fresh | rv, 0, count),
        dgtest=torch.where(fresh, p.f_dec_coeff * dg_n, s.dgtest),
        dstest=torch.where(fresh, p.s_curv_coeff * dg_n, s.dstest),
        duals=duals_n, o_it=sel(o_it_u, s.o_it),
        res_h=sel(res_h_u, s.res_h), res_g=sel(res_g_u, s.res_g),
        lb_status=torch.where(step_done | rv, status, s.lb_status),
        reeval=reeval_n, done=done_n,
        evals=s.evals + 1, inner_iters=inner_n)


# solver steps between host reads of the done mask inside flat_run
POLL_EVERY = 16


def flat_run(state: _FlatState, bound: Boundary, scaling: Scaling,
             shape: ProblemShape, grid, cfg: ALMConfig,
             p: lbfgs.LBFGSParams, max_steps: int):
    """Advance every unfinished lane by at most `max_steps` evaluations.

    Each step computes all lanes and keeps finished lanes' state (the JAX
    package's vmapped while_loop).  The host reads `done` only every
    POLL_EVERY steps, so a run may take up to POLL_EVERY-1 steps after the
    last lane finished; those change no lane.  Returns (state, steps)."""
    steps = 0
    while steps < max_steps:
        if steps % POLL_EVERY == 0 and bool(state.done.all()):
            break
        new = flat_step(state, bound, scaling, shape, grid, cfg, p)
        active = ~state.done
        state = tree_map(lambda a, b: _where(active, a, b), new, state)
        steps += 1
    return state, steps


def exact_residuals(x, duals: DualState, bound: Boundary,
                    shape: ProblemShape, grid, cfg: ALMConfig,
                    scaling: Scaling):
    """(res_h [B], res_g [B]) on the exact terrain path (judgeConvergence
    semantics, alm_traj_opt.h:140-151): the check of a solve's own
    residuals."""
    with torch.no_grad():
        h_raw, g_raw = raw_constraints(x, bound, shape, grid, cfg)
        B = x.shape[0]
        h = h_raw * scaling.scale_cx[:, 0]
        g = (g_raw * scaling.scale_cx[:, 1:7]).reshape(B, -1)
        res_h = torch.abs(h).amax(-1)
        res_g = torch.maximum(g, -duals.mu / duals.rho[:, None]).amax(-1)
    return res_h, res_g


def _traj(x, bound, shape) -> SE2Traj:
    with torch.no_grad():
        c_xy, ts_xy, c_yaw, ts_yaw, _ = _coeffs(x, bound, shape)
    return SE2Traj(c_xy=c_xy, ts_xy=ts_xy, c_yaw=c_yaw, ts_yaw=ts_yaw)


def flat_result(out: _FlatState, bound: Boundary, shape: ProblemShape,
                cfg: ALMConfig, steps: int = 0) -> ALMResult:
    converged = torch.maximum(out.res_h, out.res_g) < cfg.epsilon_con
    return ALMResult(x=out.x, traj=_traj(out.x, bound, shape),
                     converged=converged, outer_iters=out.o_it,
                     inner_iters=out.inner_iters, res_h=out.res_h,
                     res_g=out.res_g, lbfgs_status=out.lb_status,
                     evals=out.evals, steps=steps)


def solve_flat(x0, bound: Boundary, shape: ProblemShape,
               grid: tgrid.TerrainGrid, cfg: ALMConfig,
               lbfgs_overrides: dict | None = None,
               warm_duals: DualState | None = None) -> ALMResult:
    """The flat solve of every lane of x0 [B, n], run until all lanes are
    done (the JAX package's `vmap(solve_flat)`; alm.py:545-575)."""
    scaling = _make_scaling(x0, bound, shape, grid, cfg)
    p = _params(cfg, lbfgs_overrides)
    init = flat_init(x0, shape, cfg, p, warm_duals)
    out, steps = flat_run(init, bound, scaling, shape, grid, cfg, p,
                          max_steps=sys.maxsize)
    return flat_result(out, bound, shape, cfg, steps)


# ---------------------------------------------------------------------------
# Compacted batch solve
# ---------------------------------------------------------------------------

_SMALL = ("x", "o_it", "inner_iters", "res_h", "res_g", "lb_status", "evals")


def _small(st: _FlatState, return_duals: bool) -> dict:
    """Per-lane result core of the flat state."""
    core = {k: getattr(st, k) for k in _SMALL}
    if return_duals:
        core.update(lam=st.duals.lam, mu=st.duals.mu, rho=st.duals.rho)
    return core


def _cat_results(parts) -> ALMResult:
    out = [None if parts[0][i] is None else
           tree_map(lambda *a: torch.cat(a), *[r[i] for r in parts])
           for i in range(len(ALMResult._fields) - 1)]
    return ALMResult(*out, steps=sum(r.steps for r in parts))


def _set_lanes(full: ALMResult, ii, part: ALMResult) -> ALMResult:
    def put(a, b):
        a = a.clone()
        a[ii] = b
        return a
    out = [None if full[i] is None else tree_map(put, full[i], part[i])
           for i in range(len(ALMResult._fields) - 1)]
    return ALMResult(*out, steps=full.steps + part.steps)


def solve_flat_compacted(x0s, bounds, shape: ProblemShape, grid,
                         cfg: ALMConfig, lbfgs_overrides: dict | None = None,
                         chunk_steps: int = 96, buckets=(1, 4, 16),
                         max_dispatch: int = 4096,
                         retry_width: int | None = 1024,
                         warm_duals: DualState | None = None,
                         return_duals: bool = False) -> ALMResult:
    """See `_solve_flat_compacted`.  Batches wider than `max_dispatch` are
    solved in sequential slices, and unconverged lanes (at most a quarter of
    the batch) get one narrow re-solve of at most `retry_width` lanes.

    Both knobs exist in the JAX package for a TPU defect (wide programs not
    slot-invariant past lane 2048, PLATFORM_NOTES §16); they keep the same
    semantics here, where lanes are independent, so neither changes a lane
    that converged.  `retry_width=None` turns the retry off."""
    B = x0s.shape[0]
    if warm_duals is not None:
        warm_duals = _broadcast_warm_duals(warm_duals, B)
    wslice = lambda sl: (None if warm_duals is None
                         else tree_map(lambda a: a[sl], warm_duals))
    if B <= max_dispatch:
        res = _solve_flat_compacted(x0s, bounds, shape, grid, cfg,
                                    lbfgs_overrides, chunk_steps, buckets,
                                    warm_duals, return_duals)
    else:
        parts = []
        for lo in range(0, B, max_dispatch):
            sl = slice(lo, min(lo + max_dispatch, B))
            parts.append(_solve_flat_compacted(
                x0s[sl], tree_map(lambda a: a[sl], bounds), shape, grid,
                cfg, lbfgs_overrides, chunk_steps, buckets, wslice(sl),
                return_duals))
        res = _cat_results(parts)

    if retry_width is None or max_dispatch <= retry_width:
        return res
    bad = np.nonzero(~res.converged.cpu().numpy())[0]
    if bad.size == 0 or bad.size > B // 4:
        return res
    # power-of-two retry width, as the JAX package pads it
    width = 64
    while width < bad.size:
        width *= 2
    width = min(width, retry_width, B)
    pad_idx = np.concatenate([bad, np.full(max(0, width - bad.size),
                                           bad[0])])[:width]
    ip = torch.as_tensor(pad_idx, device=x0s.device)
    redo = solve_flat_compacted(
        x0s[ip], tree_map(lambda a: a[ip], bounds), shape, grid, cfg,
        lbfgs_overrides, chunk_steps, buckets,
        max_dispatch=retry_width, retry_width=None,
        warm_duals=wslice(ip), return_duals=return_duals)
    nb = min(bad.size, width)
    ii = torch.as_tensor(bad[:nb], device=x0s.device)
    redo_trim = ALMResult(*[None if v is None else
                            tree_map(lambda a: a[:nb], v)
                            for v in redo[:-1]], steps=redo.steps)
    return _set_lanes(res, ii, redo_trim)


def _solve_flat_compacted(x0s, bounds, shape: ProblemShape, grid,
                          cfg: ALMConfig, lbfgs_overrides: dict | None = None,
                          chunk_steps: int = 96, buckets=(1, 4, 16),
                          warm_duals: DualState | None = None,
                          return_duals: bool = False) -> ALMResult:
    """Batched flat solve that retires finished lanes every `chunk_steps`
    evaluations, so late rounds run at a fraction of the batch width
    (bucketed widths B // b).  Per-lane results equal `solve_flat`'s (no
    cross-lane coupling).  The host reads the live lanes' done mask once
    per round; results and state stay on the device."""
    B = x0s.shape[0]
    dev = x0s.device
    p = _params(cfg, lbfgs_overrides)
    scalings = _make_scaling(x0s, bounds, shape, grid, cfg)
    states = flat_init(x0s, shape, cfg, p, warm_duals)
    sizes = sorted({max(1, B // b) for b in buckets} | {B}, reverse=True)

    acc = None
    idx = np.arange(B)
    cur = (states, bounds, scalings)
    steps = 0
    while True:
        nlive = len(idx)
        out, n = flat_run(cur[0], cur[1], cur[2], shape, grid, cfg, p,
                          chunk_steps)
        steps += n
        done = out.done[:nlive].cpu().numpy()
        fin = np.nonzero(done)[0]
        if fin.size:
            small = _small(out, return_duals)
            if acc is None:
                acc = {k: torch.zeros((B,) + v.shape[1:], dtype=v.dtype,
                                      device=dev) for k, v in small.items()}
            src = torch.as_tensor(fin, device=dev)
            dst = torch.as_tensor(idx[fin], device=dev)
            for k, v in small.items():
                acc[k][dst] = v[src]
        still = np.nonzero(~done)[0]
        if still.size == 0:
            break
        to_size = min([s for s in sizes if s >= still.size],
                      default=sizes[0])
        ii = torch.as_tensor(np.concatenate(
            [still, np.zeros(to_size - still.size, np.int64)]), device=dev)
        cur = tuple(tree_map(lambda a: a[ii], t)
                    for t in (out, cur[1], cur[2]))
        idx = idx[still]

    converged = torch.maximum(acc["res_h"], acc["res_g"]) < cfg.epsilon_con
    duals = (DualState(lam=acc["lam"], mu=acc["mu"], rho=acc["rho"])
             if return_duals else None)
    return ALMResult(x=acc["x"], traj=_traj(acc["x"], bounds, shape),
                     converged=converged, outer_iters=acc["o_it"],
                     inner_iters=acc["inner_iters"], res_h=acc["res_h"],
                     res_g=acc["res_g"], lbfgs_status=acc["lb_status"],
                     evals=acc["evals"], duals=duals, steps=steps)
