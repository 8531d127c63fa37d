"""Port parity: the gather twins, Dubins, the bicycle step, the batched
kinodynamic search and the on-device init guess against the JAX package
(f64, coarse hill grid).  On the CPU the port runs the plain twins of its
kernels; the kernels are held against those twins in
tests/test_torch_kernels.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu import manager as jmanager
from uneven_planner_tpu.config import FrontendConfig as JFrontendConfig
from uneven_planner_tpu.config import ManagerConfig as JManagerConfig
from uneven_planner_tpu.frontend import dubins as jdubins
from uneven_planner_tpu.frontend import kino_init as jkino
from uneven_planner_tpu_torch import convert, manager
from uneven_planner_tpu_torch.config import FrontendConfig, ManagerConfig
from uneven_planner_tpu_torch.frontend import dubins, kino_init
from uneven_planner_tpu_torch.kernels import gather

from torch_parity import (CPU, assert_paths_valid, jax_grid, plan_scenarios,
                          port_grid)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """The CPU loops of these tests are thousands of small tensor
    operations, where PyTorch's thread pool only adds hand-off cost (and
    oversubscribes the cores under parallel test workers): run them on one
    thread and put the setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZING = dict(frontier_size=128, max_rounds=60)   # tests/test_frontend.py
JFE = dataclasses.replace(JFrontendConfig(), **SIZING)
FE = dataclasses.replace(FrontendConfig(), **SIZING)
RHO = FE.wheel_base / np.tan(FE.max_steer)
T = torch.tensor


@pytest.fixture(scope="module")
def grids():
    jg = jax_grid()
    return jg, port_grid(jg)


@pytest.fixture(scope="module")
def batch8(grids):
    """8 scenarios (one with its goal outside the map) searched by
    `vmap(kino_init.plan)` of the JAX package and by the port."""
    jg, tg = grids
    starts, goals = plan_scenarios(8, seed=3)
    goals[7] = [20.0, 20.0, 0.0]
    ref = jax.jit(jax.vmap(lambda s, g: jkino.plan(jg, JFE, s, g,
                                                   with_arena=True)))(
        jnp.asarray(starts), jnp.asarray(goals))
    ref = jax.tree.map(np.asarray, ref)
    got = kino_init.plan(tg, FE, T(starts), T(goals), with_arena=True)
    return starts, goals, ref, got


# ---------------------------------------------------------------------------
# gather twins
# ---------------------------------------------------------------------------

def _indices(rng, n, m):
    """Random indices with out-of-range and negative ones mixed in."""
    idx = rng.integers(0, n, m)
    idx[::7] = rng.integers(n, 3 * n, len(idx[::7]))
    idx[3::11] = -rng.integers(1, 2 * n, len(idx[3::11]))
    idx[:4] = [0, n - 1, n, -1]
    return idx


@pytest.mark.parametrize("width,n,m", [(1, 4096, 5000), (8, 1024, 5000),
                                       (128, 64, 700)])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_rows_twin_is_take_with_clip(width, n, m, idx_dtype):
    """The row-gather probes' function (e1_gather C and C2, e31 B and C) at
    cut-down sizes: bit for bit `jnp.take(table, idx, axis=0, mode="clip")`."""
    rng = np.random.default_rng(width)
    table = rng.normal(size=(n, width)).astype(np.float32)
    if width == 1:
        table = table[:, 0]
    idx = _indices(rng, n, m).astype(idx_dtype)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0,
                               mode="clip"))
    got = gather.gather_rows(T(table), T(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


def test_gather_rows_reads_a_bool_table():
    rng = np.random.default_rng(0)
    table = rng.random(977) < 0.3
    idx = _indices(rng, 977, 3000)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                               mode="clip"))
    got = gather.gather_rows(T(table), T(idx))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
def test_gather_along_twin_is_take_along_axis(axis, dtype):
    """e5_dyngather's function on a [256, 128] array, and with K != N as the
    front end reads: bit for bit `take_along_axis` on clipped indices."""
    rng = np.random.default_rng(axis)
    for shape_x, shape_i in (((256, 128), (256, 128)),
                             ((40, 300), (40, 70) if axis == 1
                              else (90, 300))):
        x = (rng.normal(size=shape_x) * 100).astype(dtype)
        n = shape_x[axis]
        idx = _indices(rng, n, int(np.prod(shape_i))).reshape(shape_i)
        want = np.take_along_axis(x, idx.clip(0, n - 1), axis=axis)
        ref = np.asarray(jnp.take_along_axis(
            jnp.asarray(x), jnp.asarray(idx.clip(0, n - 1)), axis=axis))
        np.testing.assert_array_equal(ref, want)
        for idt in (np.int32, np.int64):
            got = gather.gather_along(T(x), T(idx.astype(idt)), axis=axis)
            np.testing.assert_array_equal(got.numpy(), want)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take():
    """Wrong index types, shapes and devices raise before any build or
    launch; nothing is counted and nothing falls back to the twin."""
    before = dict(gather.launches)
    x = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        gather.gather_rows(x, torch.zeros(3))                # float index
    with pytest.raises(ValueError):
        gather.gather_rows(x, torch.zeros((3, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        gather.gather_along(x, torch.zeros((5, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        gather.gather_along(x, torch.zeros((4, 3), dtype=torch.int64),
                            axis=2)
    with pytest.raises(ValueError):
        gather.gather_rows(x.to("meta"),
                           torch.zeros(3, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        gather.gather_along(x.to("meta"), torch.zeros(
            (4, 3), dtype=torch.int64, device="meta"))
    assert gather.launches == before


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_arrays", [1, 2, 3, 8])
def test_gather_along_many_twin_is_one_gather_along_per_array(axis, idt,
                                                              n_arrays):
    """One K4 launch for several arrays read at one index: float32 and
    int32 fields mixed (the search's pool), and float64 with int64, equal
    one `gather_along_twin` per array bit for bit, at edge and
    out-of-range indices; the wrapper on CPU tensors is the twin."""
    rng = np.random.default_rng(10 * axis + n_arrays)
    shape_x, shape_i = ((40, 300), (40, 70)) if axis == 1 \
        else ((300, 40), (90, 40))
    n = shape_x[axis]
    idx = T(_indices(rng, n, int(np.prod(shape_i))).reshape(shape_i)) \
        .to(idt)
    for dtypes in ((torch.float32, torch.int32), (torch.float64,
                                                  torch.int64)):
        xs = [T(rng.normal(size=shape_x) * 1e3).to(dtypes[j % 2])
              for j in range(n_arrays)]
        want = [gather.gather_along_twin(x, idx, axis) for x in xs]
        for got in (gather.gather_along_many_twin(xs, idx, axis),
                    gather.gather_along_many(xs, idx, axis)):
            assert len(got) == n_arrays
            for g, w, x in zip(got, want, xs):
                assert g.dtype == x.dtype and torch.equal(g, w)


def test_gather_along_many_refuses_what_the_kernel_does_not_take():
    """Mixed element widths, no array or more than eight, arrays of two
    shapes: refused on every device, before anything is counted."""
    before = dict(gather.launches)
    idx = torch.zeros((4, 3), dtype=torch.int64)
    f32, i64 = torch.zeros((4, 8)), torch.zeros((4, 8), dtype=torch.int64)
    with pytest.raises(TypeError, match="width"):
        gather.gather_along_many([f32, i64], idx)
    with pytest.raises(ValueError):
        gather.gather_along_many([], idx)
    with pytest.raises(ValueError):
        gather.gather_along_many([f32] * (gather.MAX_ARRAYS + 1), idx)
    with pytest.raises(ValueError):
        gather.gather_along_many([f32, torch.zeros((4, 9))], idx)
    assert gather.launches == before


def _old_walk(parent, start, steps):
    """The search's walk as the port wrote it before `walk_parents`: a loop
    of one-column gathers."""
    node = start
    chain, valid = [], []
    for _ in range(steps):
        nid = node.clamp(min=0)
        ok = node >= 0
        chain.append(nid)
        valid.append(ok)
        node = torch.where(
            ok, gather.gather_along(parent, nid[:, None])[:, 0], -1)
    return torch.stack(chain, dim=1), torch.stack(valid, dim=1)


def _parent_forest(rng, B, A):
    """Random parent arenas: node i's parent lies below i or is a root
    (-1); unused slots hold -1, as the search leaves them."""
    parent = np.full((B, A), -1, np.int32)
    for b in range(B):
        used = rng.integers(1, A + 1)
        for i in range(1, used):
            parent[b, i] = rng.integers(-1, i)
    return parent


@pytest.mark.parametrize("B,A,steps", [(5, 40, 61), (16, 300, 7),
                                       (3, 1, 4), (1, 9, 1)])
def test_walk_parents_twin_equals_the_loop(B, A, steps):
    """`walk_parents` (its twin on the CPU) equals the loop it replaces on
    random parent forests, from random nodes, from roots, from -1 and from
    an id beyond the arena (clipped for the read, kept in the chain)."""
    rng = np.random.default_rng(B * A + steps)
    parent = T(_parent_forest(rng, B, A))
    start = T(rng.integers(0, A, B).astype(np.int32))
    start[0] = -1
    if B > 2:
        start[1], start[2] = 0, A + 5
    want = _old_walk(parent, start, steps)
    for got in (gather.walk_parents_twin(parent, start, steps),
                gather.walk_parents(parent, start, steps)):
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not want[1][0].any() and not want[0][0].any()
    # a walk stops at its root: every row is valid for a prefix only
    v = want[1].to(torch.int32)
    assert torch.equal(v, torch.sort(v, dim=1, descending=True).values)


def test_walk_parents_refuses_what_the_kernel_does_not_take():
    parent = torch.zeros((4, 8), dtype=torch.int32)
    start = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather.walk_parents(parent.long(), start, 3)
    with pytest.raises(TypeError):
        gather.walk_parents(parent, start.long(), 3)
    with pytest.raises(ValueError):
        gather.walk_parents(parent, start[:3], 3)
    with pytest.raises(ValueError):
        gather.walk_parents(parent[:, :0], start, 3)
    got = gather.walk_parents(parent, start, 0)
    assert got[0].shape == (4, 0) and got[1].shape == (4, 0)


# ---------------------------------------------------------------------------
# Dubins and the bicycle step
# ---------------------------------------------------------------------------

def _pose_pairs(n, seed):
    rng = np.random.default_rng(seed)
    q0 = np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(-np.pi, np.pi, n)]
    q1 = np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(-np.pi, np.pi, n)]
    k = n // 4      # close pairs, where the CCC words are valid
    q1[:k, :2] = q0[:k, :2] + rng.uniform(-0.4, 0.4, (k, 2))
    return q0, q1


def test_dubins_distance_matches_jax():
    q0, q1 = _pose_pairs(600, 0)
    want = jax.vmap(lambda a, b: jdubins.distance(a, b, RHO))(
        jnp.asarray(q0), jnp.asarray(q1))
    got = dubins.distance(T(q0), T(q1), RHO)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)


def test_dubins_sample_many_matches_jax():
    q0, q1 = _pose_pairs(400, 1)
    L = np.asarray(jax.vmap(lambda a, b: jdubins.distance(a, b, RHO))(
        jnp.asarray(q0), jnp.asarray(q1)))
    ss = np.linspace(0.0, 1.1, 23)[None, :] * L[:, None]   # past the end too
    want = jax.vmap(lambda a, b, s: jdubins.sample_many(a, b, RHO, s))(
        jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(ss))
    got = dubins.sample_many(T(q0), T(q1), RHO, T(ss))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)
    one = dubins.sample(T(q0), T(q1), RHO, T(ss[:, 5]))
    np.testing.assert_array_equal(one.numpy(), got[:, 5].numpy())
    # the path ends at the goal pose (yaw modulo 2 pi)
    end = dubins.sample(T(q0), T(q1), RHO, T(L)).numpy()
    np.testing.assert_allclose(end[:, :2], q1[:, :2], atol=1e-8)
    np.testing.assert_allclose(np.cos(end[:, 2] - q1[:, 2]), 1.0, atol=1e-8)


def test_state_transit_matches_jax():
    rng = np.random.default_rng(2)
    n = 500
    st = np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(-np.pi, np.pi, n)]
    lat = kino_init.control_lattice(FE)
    np.testing.assert_array_equal(lat, jkino.control_lattice(JFE))
    v = lat[rng.integers(0, len(lat), n), 0]
    steer = lat[rng.integers(0, len(lat), n), 1]
    steer[:25] = rng.uniform(-1e-4, 1e-4, 25)       # the straight branch
    tt = rng.uniform(0.05, 0.3, n)
    want = jax.vmap(lambda s, a, b, c: jkino.state_transit(
        s, a, b, c, FE.wheel_base))(*map(jnp.asarray, (st, v, steer, tt)))
    got = kino_init.state_transit(T(st), T(v), T(steer), T(tt),
                                  FE.wheel_base)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    want_cm = jkino.state_transit_cm(*map(jnp.asarray, (
        st[:, 0], st[:, 1], st[:, 2], v, steer, tt)), FE.wheel_base)
    got_cm = kino_init.state_transit_cm(*map(T, (
        st[:, 0], st[:, 1], st[:, 2], v, steer, tt)), FE.wheel_base)
    for g, w in zip(got_cm, want_cm):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

START = np.array([[-3.0, -3.0, 0.0]])
GOAL = np.array([[0.5, -3.0, 0.0]])


def test_plan_open_terrain(grids):
    _, tg = grids
    res = kino_init.plan(tg, FE, T(START), T(GOAL))
    assert bool(res.success[0]), f"no path in {int(res.rounds[0])} rounds"
    path = kino_init.extract_path(res)
    assert len(path) >= 3
    assert_paths_valid(tg, res.path.numpy(), res.path_mask.numpy(),
                       res.success.numpy(), START, GOAL,
                       FE.max_vel * FE.time_interval)
    assert float(res.cost[0]) > 0
    assert res.arena is None and res.arena_parent is None


@pytest.mark.parametrize("which", ["goal_xy", "start_se2"])
def test_occupied_start_or_goal_aborts(grids, which):
    """Occupied start (SE(2)) or goal (2D) aborts before searching
    (kino_astar.cpp:86-95): no success, zero rounds."""
    _, tg = grids
    cell = lambda p: (int((p[0] - tg.origin[0]) / tg.xy_resolution),
                      int((p[1] - tg.origin[1]) / tg.xy_resolution))
    if which == "goal_xy":
        occ_xy = tg.occ_xy.clone()
        occ_xy[cell(GOAL[0])] = True
        blocked = tg.replace(occ_xy=occ_xy)
    else:
        occ = tg.occ.clone()
        occ[cell(START[0])] = True
        blocked = tg.replace(occ=occ)
    res = kino_init.plan(blocked, FE, T(START), T(GOAL))
    assert not bool(res.success[0])
    assert int(res.rounds[0]) == 0
    assert not res.path_mask.any()


def test_plan_routes_around_obstacle(grids):
    """A wall at x = -1.5 with a gap at the top of the map; the path must
    detour through the gap, as the JAX package's does."""
    jg, tg = grids
    ix = int((-1.5 - tg.origin[0]) / tg.xy_resolution)
    occ_xy = tg.occ_xy.clone()
    occ_xy[ix:ix + 2, :34] = True
    sizing = dict(frontier_size=512, max_rounds=200)
    res = kino_init.plan(tg.replace(occ_xy=occ_xy),
                         dataclasses.replace(FE, **sizing), T(START), T(GOAL))
    assert bool(res.success[0])
    path = kino_init.extract_path(res)
    in_band = path[(path[:, 0] >= -1.6) & (path[:, 0] <= -1.2)]
    assert len(in_band) > 0, "path never crossed the wall line"
    assert in_band[:, 1].min() > 1.6, "path crossed through the wall region"
    assert float(res.cost[0]) > np.linalg.norm(GOAL[0, :2] - START[0, :2])

    ref = jkino.plan(jg.replace(occ_xy=jnp.asarray(occ_xy.numpy())),
                     dataclasses.replace(JFE, **sizing),
                     jnp.asarray(START[0]), jnp.asarray(GOAL[0]))
    assert bool(ref.success)
    assert int(res.rounds[0]) == int(ref.rounds)
    np.testing.assert_allclose(float(res.cost[0]), float(ref.cost),
                               rtol=1e-6)


def test_plan_batch_of_8_follows_the_jax_search(grids, batch8):
    """With the stable sort the port expands the same nodes in the same
    order as `vmap(kino_init.plan)`: success, rounds, the arena's parent
    pointers and the path mask are equal on every lane, cost and path agree
    to rounding."""
    _, tg = grids
    starts, goals, ref, got = batch8
    np.testing.assert_array_equal(got.success.numpy(), ref.success)
    assert ref.success.sum() >= 6 and not ref.success[7]
    np.testing.assert_array_equal(got.rounds.numpy(), ref.rounds)
    assert got.rounds.dtype == torch.int32 and int(got.rounds[7]) == 0
    np.testing.assert_array_equal(got.arena_parent.numpy(), ref.arena_parent)
    np.testing.assert_array_equal(got.path_mask.numpy(), ref.path_mask)
    ok = ref.success
    np.testing.assert_allclose(got.cost.numpy()[ok], ref.cost[ok], rtol=1e-6)
    assert np.isinf(got.cost.numpy()[~ok]).all()
    m = ref.path_mask
    np.testing.assert_allclose(got.path.numpy()[m], ref.path[m], atol=1e-9)
    used = ref.arena_parent >= 0
    np.testing.assert_allclose(got.arena.numpy()[used], ref.arena[used],
                               atol=1e-9)
    assert_paths_valid(tg, got.path.numpy(), got.path_mask.numpy(),
                       got.success.numpy(), starts, goals,
                       FE.max_vel * FE.time_interval)


def test_plan_lanes_do_not_depend_on_their_batch(grids, batch8):
    """A lane searched alone gives what it gives inside the batch: finished
    lanes are frozen while the others run on."""
    _, tg = grids
    starts, goals, _, got = batch8
    for lane in (1, 5, 7):
        one = kino_init.plan(tg, FE, T(starts[lane:lane + 1]),
                             T(goals[lane:lane + 1]))
        assert bool(one.success[0]) == bool(got.success[lane])
        assert int(one.rounds[0]) == int(got.rounds[lane])
        torch.testing.assert_close(one.path[0], got.path[lane], rtol=0,
                                   atol=0)
        torch.testing.assert_close(one.cost[0], got.cost[lane], rtol=0,
                                   atol=0)


def test_plan_on_the_bare_grid_reads_sigma_by_corners(grids):
    """Without gather tables the search scores sigma through the 8-corner
    branch; it still succeeds with valid paths."""
    _, tg = grids
    bare = tg.replace(data_pair=None, data_packed16=None)
    starts, goals = plan_scenarios(4, seed=5)
    res = kino_init.plan(bare, FE, T(starts), T(goals))
    assert res.success.all()
    assert_paths_valid(bare, res.path.numpy(), res.path_mask.numpy(),
                       res.success.numpy(), starts, goals,
                       FE.max_vel * FE.time_interval)


# ---------------------------------------------------------------------------
# init guess
# ---------------------------------------------------------------------------

def test_init_guess_fixed_device_matches_jax(batch8):
    """JAX-made paths carried over with `convert`, the failed plan's
    all-false mask included."""
    _, _, ref, _ = batch8
    want_x, want_b = jax.vmap(lambda p, m: jmanager.init_guess_fixed_jax(
        p, m, JManagerConfig(), 10, 20))(jnp.asarray(ref.path),
                                         jnp.asarray(ref.path_mask))
    kres = convert.kino_result_from_numpy(ref, device=CPU)
    assert not kres.path_mask[7].any()
    got_x, got_b = manager.init_guess_fixed_device(
        kres.path, kres.path_mask, ManagerConfig(), 10, 20)
    assert torch.isfinite(got_x).all()
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-10)
    for f in got_b._fields:
        got = getattr(got_b, f).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(getattr(want_b, f)),
                                   rtol=0, atol=1e-10)


def test_init_guess_device_agrees_with_the_host_version(batch8):
    """On a successful lane the on-device guess is the host-side
    `init_guess_fixed` of the extracted path (the yaw unwrap differs only
    in form)."""
    _, _, _, got = batch8
    x_dev, b_dev = manager.init_guess_fixed_device(
        got.path, got.path_mask, ManagerConfig(), 10, 20)
    for lane in (0, 3):
        x_host, b_host = manager.init_guess_fixed(
            kino_init.extract_path(got, lane), ManagerConfig(), 10, 20)
        np.testing.assert_allclose(x_dev[lane].numpy(), x_host, atol=1e-9)
        np.testing.assert_allclose(b_dev.tail_xy[lane].numpy(),
                                   b_host.tail_xy, atol=1e-9)


def test_init_guess_from_path_matches_jax(batch8):
    _, _, ref, _ = batch8
    path = ref.path[2][ref.path_mask[2]]
    want_x, want_b, want_shape = jmanager.init_guess_from_path(
        path, JManagerConfig())
    got_x, got_b, got_shape = manager.init_guess_from_path(path,
                                                           ManagerConfig())
    np.testing.assert_array_equal(got_x, want_x)
    assert (got_shape.piece_xy, got_shape.piece_yaw, got_shape.int_K) == \
        (want_shape.piece_xy, want_shape.piece_yaw, want_shape.int_K)
    for f in got_b._fields:
        np.testing.assert_array_equal(getattr(got_b, f), getattr(want_b, f))


def test_path_converter_adds_the_scenario_dimension(batch8):
    _, _, ref, _ = batch8
    p, m = convert.path_from_numpy(ref.path[0], ref.path_mask[0], device=CPU)
    assert p.shape == (1,) + ref.path[0].shape and m.shape == (1, p.shape[1])
    p8, m8 = convert.path_from_numpy(ref.path, ref.path_mask, device=CPU)
    assert p8.shape == ref.path.shape
    torch.testing.assert_close(p8[0], p[0], rtol=0, atol=0)
    single = jax.tree.map(lambda a: a[0], ref)
    one = convert.kino_result_from_numpy(single, device=CPU)
    assert one.success.shape == (1,) and one.arena.shape[0] == 1
