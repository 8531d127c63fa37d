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
        if jg.data_packed is not None:
            extra["data_packed"] = np.asarray(jg.data_packed)
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
# the per-lane counts of an ALMResult (the nested solve counts no evals)
COUNTS = ("evals", "outer_iters", "inner_iters", "lbfgs_status")


def lane_stability(run, x0, *args, eps=EPS, wrap=jnp.asarray):
    """Run a batched solve at x0 and at x0 * (1 + e) for each e (x0 numpy,
    handed to `run` through `wrap`).

    Returns (reference result, stable [B] bool, spread [B]): a lane is
    stable when its eval (where the solver counts them), iteration and
    status counts move under none of the perturbations, and `spread` is
    how far its x moves under the 1-ulp ones (|e| <= 1e-15).  The port
    sums in another order than XLA
    (~1e-15 relative per operation, compounding over a solve), so it can
    be held to JAX's counts exactly only on stable lanes, and to JAX's x
    only as closely as JAX reproduces itself.  The same holds between two
    batch widths of the port's CPU GEMM."""
    ref = run(wrap(x0), *args)
    counts = lambda r: np.stack([np.asarray(getattr(r, n)) for n in COUNTS
                                 if getattr(r, n) is not None])
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
    for name in COUNTS + ("converged",):
        if getattr(ref, name) is None:
            assert getattr(res, name) is None, name
            continue
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
# JAX's envelope on the host that runs the test
# ---------------------------------------------------------------------------

# the 1-ulp perturbations of a float64 x0 (lane_stability's spread runs)
ULP_EPS = (1e-15, -1e-15)
# jax_envelope's fixed sample of each lane whose counts move: a count tuple
# that carries a share p of JAX's runs is missing from RUNS_PER_LANE of
# them with probability (1 - p)^128, 1.4e-3 at p = 5%
RUNS_PER_LANE = 128


def read_alm(r):
    """(counts [B, C] int, values) of an ALMResult of either package: the
    COUNTS the solver keeps and the converged flag per lane, and x."""
    counts = [np.asarray(getattr(r, n)) for n in COUNTS + ("converged",)
              if getattr(r, n) is not None]
    return (np.stack(counts, 1).astype(np.int64),
            {"x": np.asarray(r.x, np.float64)})


class Envelope:
    """What the JAX function gives on this host at x0 and at 1-ulp
    perturbations of x0: per lane, one row per run of its counts (a tuple
    of ints) and its values (name -> float array); row 0 is the run at x0.

    The port sums in another order than XLA, and XLA's own order moves with
    the host's instruction set and threading, so the port is held to this
    set and not to one JAX run: its counts must be those of one run, and
    each value must lie in the range of the runs with those counts,
    widened by max(floor, 10 x spread), lane_stability's rule.  `spread`
    is how far a value moves among runs whose counts agree (per lane and
    quantity, the widest such group).  `floor`, the least widening, is
    lane_stability's 1e-8 unless a test passes its own absolute tolerance
    for a quantity."""

    def __init__(self, n_lanes):
        self.rows = [[] for _ in range(n_lanes)]

    def add(self, counts, values, lanes=None):
        """One run: row i of counts and values is lane lanes[i] (default
        lane i)."""
        lanes = range(len(self.rows)) if lanes is None else lanes
        for i, b in enumerate(lanes):
            self.rows[b].append((tuple(int(c) for c in counts[i]),
                                 {k: np.asarray(v[i], np.float64)
                                  for k, v in values.items()}))

    def counts(self, lane):
        return {c for c, _ in self.rows[lane]}

    def at_x0(self, name):
        """The run at x0: `name` over the lanes."""
        return np.stack([lane[0][1][name] for lane in self.rows])

    def spread(self, lane, name):
        groups = {}
        for c, v in self.rows[lane]:
            groups.setdefault(c, []).append(v[name])
        return max(float(np.ptp(np.stack(g), 0).max())
                   for g in groups.values())

    def margin(self, lane, counts, name, got, floor=None):
        """(how far `got` lies outside the range of `name` over the lane's
        runs with `counts`, negative inside; the widening allowed,
        max(floor or 1e-8, 10 x spread); how many runs have those counts),
        or None when no run has them."""
        match = [v[name] for c, v in self.rows[lane] if c == counts]
        if not match:
            return None
        runs = np.stack(match)
        got = np.asarray(got, np.float64)
        off = float(np.max(np.maximum(runs.min(0) - got, got - runs.max(0))))
        return off, max(floor or 1e-8, 10.0 * self.spread(lane, name)), \
            len(match)

    def misses(self, counts, values, floor=None):
        """The port's (counts [B, C], values name -> [B, ...]) against the
        envelope: a message for each lane whose counts no run shows and
        for each lane and quantity that lies farther outside the range of
        the runs with its counts than the widening allows (`margin`; floor
        name -> absolute floor); empty when every lane is held."""
        floor = floor or {}
        out = []
        for b in range(len(self.rows)):
            c = tuple(int(v) for v in counts[b])
            for name, got in values.items():
                m = self.margin(b, c, name, got[b], floor.get(name))
                if m is None:
                    out.append(f"lane {b}: counts {c} in none of "
                               f"{len(self.rows[b])} JAX runs "
                               f"{sorted(self.counts(b))}")
                    break
                off, w, n = m
                if not off <= w:
                    out.append(f"lane {b}: {name} {off:.3e} outside {n} "
                               f"run(s) with counts {c}, allowed {w:.3e}")
        return out


def jax_envelope(run, x0, *args, read=read_alm, lanes=False,
                 wrap=jnp.asarray):
    """Run `run(wrap(x0 * (1 + e)), *args)` at e = 0 and each e in ULP_EPS,
    read each result into (counts [B, C], values) and return the Envelope.

    With `lanes`, `run` is a batched solve whose args are per lane along
    their leading axis, and the lanes whose counts move at one of EPS (up
    to 1e-13) get RUNS_PER_LANE more runs each: batches of x0's width
    filled with copies of those lanes in turn, x0 times (1 + u) with u
    drawn per element within +-1e-15 from a fixed seed.  A lane near a
    decision then has JAX's runs on both sides of it, drawn without regard
    to the port's result."""
    x0 = np.asarray(x0)
    base_counts, values = read(run(wrap(x0), *args))
    env = Envelope(base_counts.shape[0])
    env.add(base_counts, values)
    moving = set()
    probe = tuple(e for e in EPS if e not in ULP_EPS) if lanes else ()
    for e in ULP_EPS + probe:
        c, v = read(run(wrap(x0 * (1.0 + e)), *args))
        if e in ULP_EPS:
            env.add(c, v)
        moving |= set(np.nonzero((c != base_counts).any(1))[0].tolist())
    if not lanes:
        return env
    n = x0.shape[0]
    order = np.resize(sorted(moving), RUNS_PER_LANE * len(moving))
    rng = np.random.default_rng(0)
    for k in range(0, len(order), n):
        idx = np.resize(order[k:k + n], n)
        x = x0[idx] * (1.0 + rng.uniform(-1e-15, 1e-15, x0[idx].shape))
        lane_args = jax.tree.map(lambda a: wrap(np.asarray(a)[idx]), args)
        c, v = read(run(wrap(x), *lane_args))
        m = min(n, len(order) - k)
        env.add(c[:m], {name: a[:m] for name, a in v.items()}, lanes=idx[:m])
    return env


def assert_in_envelope(env, counts, values, floor=None):
    """The port's counts [B, C] and values (name -> [B, ...]) lie in the
    JAX envelope `env` on every lane (Envelope.misses)."""
    miss = env.misses(counts, values, floor)
    assert not miss, "\n".join(miss)


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
