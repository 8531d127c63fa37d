"""Batched-sampling kinodynamic initializer (port of
`uneven_planner_tpu/frontend/kino_init.py`; same capability as the
reference's kinodynamic A*, kino_astar.cpp:67-236).

A frontier of F states per scenario expands each round through the control
lattice (v x steer, kino_astar.cpp:138-145) with the exact
constant-curvature bicycle step (stateTransit, kino_astar.h:218-240).
Candidates are collision-checked along their arcs, scored with the
reference g-score terms, deduplicated per (x, y, yaw-bin) cell by
scatter-min, merged into a persistent open pool and pruned to the best by
f = g + lambda_heu * h.  Within oneshot_range of the goal a closed-form
Dubins connection is tried.  Parent pointers in a preallocated arena give
the path.

Where the JAX package maps a single-scenario `plan` over scenarios with
`vmap`, `plan` here carries the scenario dimension B itself: every per-node
array is [B, ...].  Each `a[idx]` of the single-scenario code is then a read
along axis 1, and goes through the gather kernel K4
(`kernels/gather.py:gather_along`); occupancy and sigma go through the grid
lookups (kernels K3 and K1).  The scatter-mins and the selections of the
best F and the best Pn stay PyTorch calls.

Selection order.  `jax.lax.top_k` returns the lower index first among equal
values; `torch.topk` promises no order.  The open pool is mostly +inf and
mirror-image steers give equal finite f, so ties are common.  Selection here
is a stable ascending sort of f, which puts the lower index first among
equals: the search then expands the same nodes in the same order as the JAX
package's, and two runs of it agree with each other.

The loop is the JAX package's `vmap(while_loop)`: it runs until every
scenario is done, and a finished scenario's state is frozen field by field.
The two large per-scenario arrays (`best_g` and the arena) are updated in
place, with a finished scenario's updates masked out, instead of being
copied each round.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from uneven_planner_tpu_torch.config import FrontendConfig
from uneven_planner_tpu_torch.frontend import dubins
from uneven_planner_tpu_torch.kernels.gather import gather_along
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.grid import _div, _to_index


# rounds between two host reads of the `done` flags
POLL_EVERY = 4


def control_lattice(cfg: FrontendConfig) -> np.ndarray:
    """The reference's input cross product (kino_astar.cpp:138-145), minus
    the no-op v=0 rows."""
    vs = [0.5 * cfg.max_vel, cfg.max_vel]
    steers = [-cfg.max_steer, -0.5 * cfg.max_steer, 0.0,
              0.5 * cfg.max_steer, cfg.max_steer]
    return np.asarray([[v, s] for v in vs for s in steers])


def state_transit_cm(x, y, yaw, v, steer, T, wheel_base: float):
    """Exact constant-curvature propagation (kino_astar.h:218-240) on
    coordinate tensors that broadcast: (x', y', yaw')."""
    s = v * T
    t = _div(s * torch.tan(steer), wheel_base)
    sx = x + s * torch.cos(yaw)
    sy = y + s * torch.sin(yaw)
    r = s / torch.where(torch.abs(t) > 1e-12, t, 1.0)
    tx = x + r * (torch.sin(yaw + t) - torch.sin(yaw))
    ty = y - r * (torch.cos(yaw + t) - torch.cos(yaw))
    tyaw = tgrid.normalize_so2(yaw + t)
    turn = torch.abs(steer) > 1e-4
    return (torch.where(turn, tx, sx), torch.where(turn, ty, sy),
            torch.where(turn, tyaw, yaw))


def state_transit(state, v, steer, T, wheel_base: float) -> torch.Tensor:
    """`state_transit_cm` on [..., 3] states."""
    return torch.stack(state_transit_cm(
        state[..., 0], state[..., 1], state[..., 2], v, steer, T,
        wheel_base), dim=-1)


class KinoResult(NamedTuple):
    path: torch.Tensor        # [B, L, 3] SE(2) path (start -> goal), padded
    path_mask: torch.Tensor   # [B, L] valid entries
    success: torch.Tensor     # [B] bool
    cost: torch.Tensor        # [B] g + shot length
    rounds: torch.Tensor      # [B] int32
    # Expanded-node record (visExpanded, kino_astar.cpp:266-276), only from
    # plan(..., with_arena=True): [B, arena_n, 3] states and the parent
    # arena id of each (-1 = unused slot).
    arena: torch.Tensor | None = None
    arena_parent: torch.Tensor | None = None


def _yaw_bins(cfg: FrontendConfig) -> int:
    return max(int(math.ceil(2.0 * math.pi / cfg.dedup_yaw_resolution)), 1)


def _frozen(done, old, new):
    """`new` where the scenario is still running, `old` where it is done."""
    return torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), old, new)


def plan(grid: tgrid.TerrainGrid, cfg: FrontendConfig, start: torch.Tensor,
         goal: torch.Tensor, n_shot_samples: int = 64,
         with_arena: bool = False) -> KinoResult:
    """Search init paths for B scenarios at once: start, goal [B, 3] on the
    grid's device.  The host reads the `done` flags every POLL_EVERY rounds;
    rounds run after every scenario finished change nothing."""
    with torch.no_grad():
        return _plan(grid, cfg, start, goal, n_shot_samples, with_arena)


def _plan(grid, cfg, start, goal, n_shot_samples, with_arena):
    B = start.shape[0]
    dev, dtype = start.device, start.dtype
    F, R = cfg.frontier_size, cfg.max_rounds
    lattice = control_lattice(cfg)
    I = lattice.shape[0]
    rho = cfg.wheel_base / math.tan(cfg.max_steer)
    nyaw_bins = _yaw_bins(cfg)
    nx, ny, _ = grid.voxel_num
    res = grid.xy_resolution
    # the dedup grid must be finer than the per-round arc progress or every
    # candidate lands in its parent's cell and the wavefront stalls
    dedup_res = cfg.dedup_resolution or min(
        res, 0.5 * cfg.max_vel * cfg.time_interval)
    nx_d = int(math.ceil(nx * res / dedup_res))
    ny_d = int(math.ceil(ny * res / dedup_res))
    n_cells = nx_d * ny_d * nyaw_bins
    n_col = max(int(math.ceil(cfg.max_vel * cfg.time_interval
                              / cfg.collision_interval)), 1)
    arena_n = 1 + F * R
    FI = F * I
    Pn = 8 * F                      # persistent open pool (batched A*)
    S = n_shot_samples
    i32 = torch.int32
    const = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)
    full = lambda shape, v, dt=dtype: torch.full(shape, v, dtype=dt,
                                                 device=dev)
    lat_v = const(np.tile(lattice[:, 0], F))                  # [FI]
    lat_s = const(np.tile(lattice[:, 1], F))
    parent_lane = torch.arange(F, device=dev, dtype=i32).repeat_interleave(I)
    cand_no = torch.arange(FI, device=dev, dtype=i32)
    fan = lambda a: a.repeat_interleave(I, dim=1)     # a[:, parent_lane]
    ox, oy, _ = grid.origin
    gx, gy = goal[:, 0:1], goal[:, 1:2]
    goal_b = goal[:, None, :]

    def cells_of(cx, cy, cyaw):
        ix = _to_index(torch.floor(_div(cx - ox, dedup_res))) \
            .clamp(0, nx_d - 1)
        iy = _to_index(torch.floor(_div(cy - oy, dedup_res))) \
            .clamp(0, ny_d - 1)
        ib = _to_index(torch.floor(_div(
            tgrid.normalize_so2(cyaw) + math.pi, cfg.dedup_yaw_resolution))) \
            .clamp(0, nyaw_bins - 1)
        return ((ix * ny_d + iy) * nyaw_bins + ib).to(i32)

    def heu(cx, cy):
        return (1.0 + 1.0 / 10000) * torch.hypot(cx - gx, cy - gy)

    shot_ss = torch.arange(S, device=dev, dtype=dtype) \
        * cfg.collision_interval

    def try_shot(ex, ey, eyaw, g_shot):
        """Dubins connections to the goal with collision checks, over all
        [B, F] expanded states (asignShotTraj, kino_astar.h:242-271)."""
        near = torch.hypot(ex - gx, ey - gy) < cfg.oneshot_range
        q0 = torch.stack([ex, ey, eyaw], dim=-1)               # [B, F, 3]
        Ls = dubins.distance(q0, goal_b, rho)                  # [B, F]
        valid_s = shot_ss <= Ls[..., None]                     # [B, F, S]
        pts = dubins.sample_many(q0, goal_b, rho,
                                 torch.minimum(shot_ss, Ls[..., None]))
        occ = tgrid.is_occupancy_xy_batch(grid, pts[..., 0], pts[..., 1])
        blocked = (occ & valid_s).any(-1)
        fits = Ls <= (S - 1) * cfg.collision_interval
        ok = near & ~blocked & fits
        return torch.where(ok, g_shot + Ls, math.inf)

    # ---- initial state
    start_yaw = tgrid.normalize_so2(start[:, 2])
    start_n = torch.stack([start[:, 0], start[:, 1], start_yaw], dim=1)
    # occupied start (SE(2)) or goal (2D) aborts before searching
    # (kino_astar.cpp:86-95)
    feasible = ~tgrid.is_occupancy(grid, start_n) \
        & ~tgrid.is_occupancy_xy(grid, goal[:, :2])
    col = lambda a, n: a[:, None].expand(B, n).contiguous()
    # the open pool, one [B, Pn] array per field: pose, g, f (inf = empty or
    # closed), arrival inputs v and steer, arena id of the generating parent
    pool = dict(x=col(start[:, 0], Pn), y=col(start[:, 1], Pn),
                yaw=col(start_yaw, Pn), g=full((B, Pn), math.inf),
                f=full((B, Pn), math.inf), v=full((B, Pn), 0.0),
                steer=full((B, Pn), 0.0), parent=full((B, Pn), 0, i32))
    pool["g"][:, 0] = 0.0
    pool["f"][:, 0] = torch.where(
        feasible, cfg.lambda_heu * heu(start_n[:, 0:1], start_n[:, 1:2])[:, 0],
        math.inf)
    best_g = full((B, n_cells), math.inf)
    best_g.scatter_(1, cells_of(start[:, 0:1], start[:, 1:2],
                                start_yaw[:, None]).long(), 0.0)
    arena_x, arena_y = col(start[:, 0], arena_n), col(start[:, 1], arena_n)
    arena_yaw = col(start_yaw, arena_n)
    arena_parent = full((B, arena_n), -1, i32)
    rnd = full((B,), 0, i32)
    shot_ok = full((B,), False, torch.bool)
    shot_cost = full((B,), math.inf)
    shot_node = full((B,), 0, i32)                 # arena id of shot origin
    done = ~feasible

    for it in range(R):
        if it % POLL_EVERY == 0 and bool(done.all()):
            break
        live = ~done[:, None]
        # the best F open nodes expand and become arena nodes
        sel = torch.sort(pool["f"], dim=1, stable=True).indices[:, :F] \
            .contiguous()
        exp = {k: gather_along(a, sel) for k, a in pool.items()}
        exp_x, exp_y, exp_yaw, exp_g = (exp[k] for k in ("x", "y", "yaw", "g"))
        active = torch.isfinite(exp["f"])
        closed_f = pool["f"].scatter(1, sel, math.inf)

        base = 1 + it * F           # every running scenario is in round `it`
        span = slice(base, base + F)
        arena_x[:, span] = torch.where(live, exp_x, arena_x[:, span])
        arena_y[:, span] = torch.where(live, exp_y, arena_y[:, span])
        arena_yaw[:, span] = torch.where(live, exp_yaw, arena_yaw[:, span])
        arena_parent[:, span] = torch.where(live & active, exp["parent"],
                                            arena_parent[:, span])

        # one-shot attempts from the expanded set (best lane wins); totals
        # is inf wherever the shot is not ok, so a total below the best so
        # far is a hit
        totals = try_shot(exp_x, exp_y, exp_yaw,
                          torch.where(active, exp_g, math.inf))
        best_lane = totals.argmin(dim=1, keepdim=True)          # [B, 1]
        best_total = gather_along(totals, best_lane)[:, 0]
        hit = best_total < shot_cost
        new_shot_ok = shot_ok | hit
        new_shot_cost = torch.where(hit, best_total, shot_cost)
        new_shot_node = torch.where(hit, base + best_lane[:, 0].to(i32),
                                    shot_node)

        # expand through the control lattice: [B, FI] candidate arrays
        px0, py0, pyaw0 = fan(exp_x), fan(exp_y), fan(exp_yaw)
        cx, cy, cyaw = state_transit_cm(px0, py0, pyaw0, lat_v, lat_s,
                                        cfg.time_interval, cfg.wheel_base)
        in_map = (cx > ox + 1e-4) & (cx < ox + nx * res - 1e-4) \
            & (cy > oy + 1e-4) & (cy < oy + ny * res - 1e-4)
        # collision sampling along the arcs (kino_astar.cpp:171-185)
        fr = _div(torch.arange(1, n_col + 1, device=dev, dtype=dtype),
                  n_col) * cfg.time_interval
        ax_, ay_, _ = state_transit_cm(
            px0[..., None], py0[..., None], pyaw0[..., None],
            lat_v[:, None], lat_s[:, None], fr, cfg.wheel_base)
        free = ~tgrid.is_occupancy_xy_batch(grid, ax_, ay_).any(-1)
        sig = tgrid.terrain_sigma_cm(grid, cx, cy, tgrid.normalize_so2(cyaw))

        arc = lat_v * cfg.time_interval
        dg = (cfg.weight_r2 * arc
              + cfg.weight_so2 * torch.abs(lat_s) * arc
              + cfg.weight_v_change * torch.abs(lat_v - fan(exp["v"]))
              + cfg.weight_delta_change * torch.abs(lat_s - fan(exp["steer"]))
              + cfg.weight_sigma * sig)
        ok = fan(active) & in_map & free
        g_new = torch.where(ok, fan(exp_g) + dg, math.inf)

        # per-cell winners via scatter-min (dedup within the round and
        # against all previously accepted nodes)
        cells = cells_of(cx, cy, cyaw)
        cells64 = cells.long()
        round_best = full((B, n_cells), math.inf).scatter_reduce_(
            1, cells64, g_new, "amin")
        improved = (g_new <= gather_along(round_best, cells)) \
            & (g_new < gather_along(best_g, cells) - 1e-9) \
            & torch.isfinite(g_new)
        first_idx = full((B, n_cells), FI, i32).scatter_reduce_(
            1, cells64, torch.where(improved, cand_no, FI), "amin")
        winner = improved & (gather_along(first_idx, cells) == cand_no)
        f_cand = torch.where(winner, g_new + cfg.lambda_heu * heu(cx, cy),
                             math.inf)

        # merge the pool (minus the expanded) with the winners, keep the
        # best Pn by f
        merged_f = torch.cat([closed_f, f_cand], dim=1)
        keep = torch.sort(merged_f, dim=1, stable=True).indices[:, :Pn] \
            .contiguous()
        cand = dict(x=cx, y=cy, yaw=cyaw, g=g_new, f=f_cand, v=lat_v,
                    steer=lat_s, parent=base + parent_lane)
        new_pool = {k: gather_along(
            merged_f if k == "f" else torch.cat(
                [pool[k], cand[k].expand(B, FI)], dim=1), keep)
            for k in pool}

        # accepted candidates (kept, and from the candidate part) claim
        # best_g; in place, with a finished scenario claiming nothing
        cand_keep = (keep >= Pn) & live
        claim_cells = torch.where(
            cand_keep, gather_along(cells, (keep - Pn).clamp(min=0)), 0)
        best_g.scatter_reduce_(
            1, claim_cells.long(), torch.where(cand_keep, new_pool["g"], math.inf),
            "amin")

        any_open = torch.isfinite(new_pool["f"]).any(dim=1)
        new_done = new_shot_ok | (it + 1 >= R) | ~any_open

        pool = {k: _frozen(done, pool[k], new_pool[k]) for k in pool}
        rnd = _frozen(done, rnd, torch.full_like(rnd, it + 1))
        shot_ok = _frozen(done, shot_ok, new_shot_ok)
        shot_cost = _frozen(done, shot_cost, new_shot_cost)
        shot_node = _frozen(done, shot_node, new_shot_node)
        done = done | new_done

    # ---- path reconstruction (retrievePath, kino_astar.h:273-292)
    node = shot_node
    chain, valid = [], []
    for _ in range(R + 1):
        nid = node.clamp(min=0)
        ok = node >= 0
        chain.append(nid)
        valid.append(ok)
        node = torch.where(ok, gather_along(arena_parent, nid[:, None])[:, 0],
                           -1)
    rev_ids = torch.stack(chain, dim=1)                        # [B, R+1]
    rev_valid = torch.stack(valid, dim=1)
    # reverse into start -> shot order, left-aligned
    n_valid = rev_valid.sum(dim=1, dtype=i32)
    idx = n_valid[:, None] - 1 - torch.arange(R + 1, device=dev, dtype=i32)
    tree_mask = idx >= 0
    ids = gather_along(rev_ids, idx.clamp(0, R))
    tree_states = torch.stack(
        [torch.where(tree_mask, gather_along(a, ids), 0.0)
         for a in (arena_x, arena_y, arena_yaw)], dim=-1)      # [B, R+1, 3]

    shot_state = torch.stack(
        [gather_along(a, shot_node[:, None])[:, 0]
         for a in (arena_x, arena_y, arena_yaw)], dim=-1)      # [B, 3]
    L = dubins.distance(shot_state, goal, rho)[:, None]
    ss = torch.arange(1, S + 1, device=dev, dtype=dtype) \
        * cfg.collision_interval
    shot_pts = dubins.sample_many(shot_state, goal, rho,
                                  torch.minimum(ss, L))        # [B, S, 3]

    path = torch.cat([tree_states, shot_pts, goal[:, None, :]], dim=1)
    mask = torch.cat([tree_mask, ss <= L,
                      full((B, 1), True, torch.bool)], dim=1) \
        & shot_ok[:, None]
    arena = (torch.stack([arena_x, arena_y, arena_yaw], dim=-1)
             if with_arena else None)
    return KinoResult(path=path, path_mask=mask, success=shot_ok,
                      cost=shot_cost, rounds=rnd, arena=arena,
                      arena_parent=arena_parent if with_arena else None)


def extract_path(result: KinoResult, lane: int = 0) -> np.ndarray:
    """Host-side ragged path of one scenario (rows in order, masked rows
    dropped)."""
    m = result.path_mask[lane].cpu().numpy()
    return result.path[lane].cpu().numpy()[m]
