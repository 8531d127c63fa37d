"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py):
the coarse hill grid of tests/test_alm.py in both packages, hill scenarios
drawn with numpy from a seed (straight-line init guesses for the solver
tests, start/goal poses for the front-end tests), and the checks the
front-end tests share (collision-free, reaches the goal)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from uneven_planner_tpu import manager as jmanager
from uneven_planner_tpu.config import ManagerConfig, MapConfig
from uneven_planner_tpu.terrain import grid as jgrid
from uneven_planner_tpu.terrain.synthetic import make_synthetic_grid

from uneven_planner_tpu_torch import convert

TEST_CFG = MapConfig(xy_resolution=0.2, yaw_resolution=0.45)
CPU = torch.device("cpu")


def jax_grid(dtype=np.float64):
    """Coarse hill grid with the pair and f16 tables (JAX package)."""
    g = make_synthetic_grid(TEST_CFG, dtype=dtype)
    return jgrid.with_packed_f16(jgrid.with_pair_table(g))


def port_grid(jg, tables_from_jax=False):
    """The same field in the port, on the CPU.  Tables are rebuilt by the
    port unless `tables_from_jax`, which converts the JAX package's."""
    extra = {}
    if tables_from_jax:
        extra = dict(data_pair=np.asarray(jg.data_pair),
                     data_packed16=np.asarray(jg.data_packed16))
    return convert.grid_from_numpy(
        np.asarray(jg.data), xy_resolution=jg.xy_resolution,
        yaw_resolution=jg.yaw_resolution, origin=jg.origin,
        occ=np.asarray(jg.occ), occ_xy=np.asarray(jg.occ_xy),
        gravity=jg.gravity, device=CPU, **extra)


def scenarios(n, seed, piece_xy, piece_yaw, reach=2.0):
    """n straight-line hill scenarios -> (x0 [n, nv], Boundary of [n, ...]
    numpy arrays), built by the JAX package's init guess."""
    rng = np.random.default_rng(seed)
    xs, bs = [], []
    for _ in range(n):
        ang = rng.uniform(-np.pi, np.pi)
        start = rng.uniform(-3.5, -1.5, size=2)
        goal = np.clip(start + reach * np.array([np.cos(ang), np.sin(ang)]),
                       -4, 4)
        yaw = np.arctan2(goal[1] - start[1], goal[0] - start[0])
        t = np.linspace(0, 1, 16)[:, None]
        path = np.concatenate([(1 - t) * start + t * goal,
                               np.full((16, 1), yaw)], axis=1)
        xi, bi = jmanager.init_guess_fixed(path, ManagerConfig(),
                                           piece_xy=piece_xy,
                                           piece_yaw=piece_yaw)
        xs.append(xi)
        bs.append(bi)
    return np.stack(xs), jax.tree.map(lambda *a: np.stack(a), *bs)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


EPS = (1e-15, -1e-15, 1e-14, -1e-14, 1e-13, -1e-13)


def lane_stability(run, x0, *args, eps=EPS, wrap=jnp.asarray):
    """Run a batched solve at x0 and at x0 * (1 + e) for each e (x0 numpy,
    handed to `run` through `wrap`).

    Returns (reference result, stable [B] bool, spread [B]): a lane is
    stable when its eval, iteration and status counts move under none of
    the perturbations, and `spread` is how far its x moves under the 1-ulp
    ones (|e| <= 1e-15).  The port sums in another order than XLA
    (~1e-15 relative per operation, compounding over a solve), so it can
    be held to JAX's counts exactly only on stable lanes, and to JAX's x
    only as closely as JAX reproduces itself.  The same holds between two
    batch widths of the port's CPU GEMM."""
    ref = run(wrap(x0), *args)
    counts = lambda r: np.stack([np.asarray(r.evals), np.asarray(r.outer_iters),
                                 np.asarray(r.inner_iters),
                                 np.asarray(r.lbfgs_status)])
    c0, x_ref = counts(ref), np.asarray(ref.x)
    stable = np.ones(x0.shape[0], bool)
    spread = np.zeros(x0.shape[0])
    for e in eps:
        r = run(wrap(x0 * (1.0 + e)), *args)
        stable &= (counts(r) == c0).all(axis=0)
        if abs(e) <= 1e-15:
            spread = np.maximum(spread,
                                np.abs(np.asarray(r.x) - x_ref).max(1))
    return ref, stable, spread


def assert_lanes_match(ref, res, stable, spread, min_stable):
    """Lane-by-lane parity of a port result with a reference result: on stable
    lanes equal evals, outer and inner iterations, L-BFGS status and
    converged, and x within max(1e-8, 10 x JAX's own spread); on the others
    the same converged flag and the same optimum within the ALM tolerance
    band (2e-2, as tests/test_alm.py holds flat vs nested)."""
    assert stable.sum() >= min_stable, stable
    for name in ("evals", "outer_iters", "inner_iters", "lbfgs_status",
                 "converged"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(res, name))
        np.testing.assert_array_equal(b[stable], a[stable], err_msg=name)
    np.testing.assert_array_equal(np.asarray(res.converged),
                                  np.asarray(ref.converged))
    dx = np.abs(np.asarray(res.x) - np.asarray(ref.x)).max(1)
    tol = np.maximum(1e-8, 10.0 * spread)
    assert (dx[stable] <= tol[stable]).all(), (dx, tol, stable)
    assert (dx < 2e-2).all(), dx


# ---------------------------------------------------------------------------
# Front-end cases
# ---------------------------------------------------------------------------

def plan_scenarios(n, seed, reach=2.5):
    """n start/goal pose pairs on the hill ([n, 3] numpy each), drawn as the
    JAX package's front-end benchmark draws them."""
    rng = np.random.default_rng(seed)
    starts, goals = [], []
    for _ in range(n):
        ang = rng.uniform(-np.pi, np.pi)
        s = rng.uniform(-3.5, -1.5, size=2)
        g = np.clip(s + reach * np.array([np.cos(ang), np.sin(ang)]),
                    -4.0, 4.0)
        yaw = np.arctan2(g[1] - s[1], g[0] - s[0])
        starts.append([s[0], s[1], yaw])
        goals.append([g[0], g[1], yaw])
    return np.asarray(starts), np.asarray(goals)


def occupied_xy(grid, xy):
    """2D occupancy of [n, 2] numpy points on a grid of either package,
    out-of-map counted as occupied (numpy; independent of both lookups)."""
    occ = np.asarray(grid.occ_xy)
    ix = np.floor((xy[:, 0] - grid.origin[0]) / grid.xy_resolution).astype(int)
    iy = np.floor((xy[:, 1] - grid.origin[1]) / grid.xy_resolution).astype(int)
    inside = (ix >= 0) & (ix < occ.shape[0]) & (iy >= 0) & (iy < occ.shape[1])
    return ~inside | occ[ix.clip(0, occ.shape[0] - 1),
                         iy.clip(0, occ.shape[1] - 1)]


def assert_paths_valid(grid, path, mask, success, starts, goals, max_step):
    """Every successful lane's path starts at its start, ends at its goal,
    is collision-free and takes bounded steps; a failed lane's mask is
    empty.  path [B, L, 3], mask [B, L], success [B] as numpy."""
    for b in range(path.shape[0]):
        if not success[b]:
            assert not mask[b].any(), b
            continue
        p = path[b][mask[b]]
        assert len(p) >= 2, b
        np.testing.assert_allclose(p[0, :2], starts[b, :2], atol=1e-6)
        np.testing.assert_allclose(p[-1], goals[b], atol=1e-5)
        assert not occupied_xy(grid, p[:, :2]).any(), b
        d = np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1)
        assert d.max() < max_step + 1e-6, (b, d.max())
