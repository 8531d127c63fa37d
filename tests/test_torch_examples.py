"""The port's user entry points (`uneven_planner_tpu_torch.examples`:
plan_demo, debug_stepper, build_maps) against the JAX calls that
examples/plan_demo.py, examples/debug_stepper.py and examples/build_maps.py
make on the same inputs, on the CPU: the coarse hill
`MapConfig(xy_resolution=0.2, yaw_resolution=0.45)` in float64 for the
planner, a small sampled hill cloud written as a PCD for the map builder."""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu import manager as jmanager
from uneven_planner_tpu.config import MapConfig as JMapConfig
from uneven_planner_tpu.config import scene_config as jscene_config
from uneven_planner_tpu.frontend import kino_init as jkino
from uneven_planner_tpu.minco import traj as jtraj
from uneven_planner_tpu.mpc import traj_msg as jtraj_msg
from uneven_planner_tpu.sim import rollout as jrollout
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu.terrain import build as jbuild
from uneven_planner_tpu.terrain import grid as jgrid
from uneven_planner_tpu.terrain.synthetic import make_synthetic_grid as jhill
from uneven_planner_tpu.utils import native as jnative
from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.examples import (build_maps, debug_stepper,
                                               plan_demo)
from uneven_planner_tpu_torch.terrain import io, mesh
from uneven_planner_tpu_torch.utils import native

from torch_parity import (TEST_CFG, assert_in_envelope, jax_envelope,
                          lane_stability)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the ALM band: the JAX package holds its own flat and nested solves of one
# problem to it (tests/test_alm.py:309, :408): x of a lane the port and JAX
# may take apart by an ulp-level decision
TOL_BAND = 2e-2
# debug_stepper's rows: the floors of its envelope, where JAX's 1-ulp
# spread is smaller (the first evaluations, before rounding compounds).
# Iterates: lane_stability's floor (tests/torch_parity.py).  Values: at a
# common iterate the two packages differ only in the order of summation, a
# value being a sum of ~2,000 float64 terms (170 samples x the penalty
# terms, and the jerk): at most ~2,000 x 1.1e-16 = 2.2e-13 of its size;
# 1e-10 of the lane's largest value leaves 450x for the iterates' drift
TOL_ROWS_X = 1e-8
TOL_ROWS_F = 1e-10
# the mean tracking error of two plans held to each other within TOL_BAND
# (two solves of one problem, the port's and JAX's): the same band,
# relative to the error
TOL_TRACK_REL = TOL_BAND
# built maps: every cell, the median cell (their reckoning at
# tests/test_torch_build.py TOL_CELL, TOL_MEDIAN)
TOL_CELL, TOL_MEDIAN = 2e-3, 1e-6
BUILD_CFG = MapConfig(xy_resolution=0.4, yaw_resolution=0.8)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Small tensor loops: one thread (see tests/test_torch_nested.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_hill():
    """examples/plan_demo.py's grid on the coarse map, in float64, with the
    tables the port's demo attaches (the solve reads the pair table)."""
    g = jhill(JMapConfig(xy_resolution=0.2, yaw_resolution=0.45),
              dtype=np.float64)
    return jgrid.with_packed_f16(jgrid.with_pair_table(g))


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("demo") / "traj.csv")
    lines = []
    r = plan_demo.run(TEST_CFG, track=True, out=out, device="cpu",
                      dtype=np.float64, log=lines.append,
                      cache_dir=str(tmp_path_factory.mktemp("cache")))
    return r, out, lines


def test_plan_demo_matches_jax(demo, jax_hill):
    """plan_demo's search, nested solve and post-solve report against the
    JAX calls of examples/plan_demo.py on the same grid, start and goal:
    search success and rounds equal; converged equal, and outer rounds
    and inner iterations equal when no 1e-15 or 1e-14 change of x0 moves
    JAX's counts (`lane_stability`, as tests/test_torch_nested.py); x
    within 1e-8 then, within the ALM band otherwise; the report's six
    maxima within the ALM band of JAX's and its equal error (a sum over
    2048 samples that each outer round shrinks) below tests/test_alm.py's
    0.5 in both; the mean tracking error within TOL_TRACK_REL.  (On this
    grid the lane is not stable.  On an AMD EPYC host JAX takes 6 outer
    rounds with 72 inner iterations at x0, at x0 (1 +- 1e-15) and at 64
    random 1-ulp changes of x0, 67 at x0 (1 + 1e-14), and 8 rounds only
    at x0 (1 + 1e-10); the port's solve of JAX's x0 takes 8 rounds (78
    iterations), and at x0 (1 +- 1e-14) JAX's 6 (67, 72): the port's
    order of summation moves this lane farther than an ulp of x0 does,
    which is why it is held to the ALM band and no envelope.)"""
    r, _, lines = demo
    scfg = jscene_config("hill")
    start = jnp.asarray([-3.0, -3.0, 0.0])
    goal = jnp.asarray([0.0, -3.0, 0.0])
    kres = jax.jit(lambda s, g, gr: jkino.plan(gr, scfg.frontend, s, g))(
        start, goal, jax_hill)
    assert bool(r.kres.success[0]) == bool(kres.success) is True
    assert int(r.kres.rounds[0]) == int(kres.rounds)

    shape = jalm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
    x0, bound = jmanager.init_guess_fixed_jax(
        kres.path, kres.path_mask, scfg.manager, 10, 20)
    run = jax.jit(jax.vmap(lambda x, b: jalm.solve(
        x, b, shape, jax_hill, scfg.alm,
        lbfgs_overrides=plan_demo.LBFGS_OVERRIDES), in_axes=(0, None)))
    ref, stable, _ = lane_stability(run, np.asarray(x0)[None], bound,
                                    eps=(1e-15, -1e-15, 1e-14, -1e-14))
    res = r.res
    assert bool(res.converged[0]) == bool(ref.converged[0]) is True
    dx = float(np.abs(res.x.numpy() - np.asarray(ref.x)).max())
    if stable[0]:
        for name in ("outer_iters", "inner_iters", "lbfgs_status"):
            assert int(getattr(res, name)[0]) == int(getattr(ref, name)[0])
        assert dx <= TOL_ROWS_X, dx
    assert dx <= TOL_BAND, dx

    tr = jax.tree.map(lambda a: a[0], ref.traj)
    m = jtraj.max_metrics(tr, jax_hill, plan_demo.METRIC_SAMPLES)
    want = {k: float(v) for k, v in m.items()}
    want["non_hol"] = float(jtraj.non_hol_error(tr, plan_demo.METRIC_SAMPLES))
    assert set(r.report) == set(want)
    for k, v in want.items():
        if k == "non_hol":
            assert max(r.report[k], v) < 0.5, (r.report[k], v)
        else:
            assert abs(r.report[k] - v) <= TOL_BAND * max(abs(v), 1.0), \
                (k, r.report[k], v)
    assert r.lines == lines[3:10]
    assert r.lines[0].startswith("equal error: ")
    assert [ln.split(":")[0] for ln in r.lines[1:]] == [
        "max vx rate", "max ax rate", "max ay rate", "max cur",
        "min cosxi", "max sigma"]

    # --track: the wire round trip and 600 ticks with one relinearisation
    jt = jtraj_msg.traj_from_msg(jtraj_msg.msg_from_traj(tr))
    tres = jax.jit(lambda tr_, s: jrollout.track_trajectory(
        tr_, s, scfg.mpc, n_steps=plan_demo.TRACK_STEPS, max_sqp_iter=1))(
        jt, start)
    assert r.track.errs.shape == (1, plan_demo.TRACK_STEPS)
    np.testing.assert_allclose(float(r.track.mean_err[0]),
                               float(tres.mean_err), rtol=TOL_TRACK_REL)
    assert float(r.track.mean_err[0]) <= 0.05


def test_plan_demo_exports_finite_se3_poses(demo):
    """--out: the x,y,z,yaw CSV of the trajectory sampled every 0.03 s,
    z on the hill's surface (the grid's z at the pose)."""
    r, out, _ = demo
    with open(out) as f:
        assert f.readline().strip() == "x,y,z,yaw"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    T = float(r.res.traj.ts_xy[0].sum())
    assert rows.shape == (int(np.floor(T / 0.03)) + 1, 4)
    assert np.isfinite(rows).all()
    np.testing.assert_allclose(rows, r.poses, rtol=1e-12)
    np.testing.assert_allclose(rows[0, :2], [-3.0, -3.0], atol=1e-9)
    assert np.abs(rows[:, 2]).max() < 1.0


def _jax_stepper_rows(jg, scale=1.0):
    """The iterates and CSV rows of examples/debug_stepper.py, computed as
    it computes them, on the coarse float64 hill with its pair table, from
    the stepper's x0 times `scale`."""
    cfg = jscene_config("hill")
    shape = jalm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
    x0, bound = jmanager.init_guess_fixed(debug_stepper.fixed_path(),
                                          cfg.manager, 10, 20)
    bound = jax.tree.map(jnp.asarray, bound)
    rec = jax.jit(lambda x, b, g: jalm.debug_iterates(
        x, b, shape, g, cfg.alm, max_evals=debug_stepper.MAX_EVALS,
        lbfgs_overrides=debug_stepper.LBFGS_OVERRIDES))(
        jnp.asarray(x0 * scale), bound, jg)
    rec = jax.tree.map(np.asarray, rec)
    n_valid = int(rec["valid"].sum())
    u = np.linspace(0.0, 1.0, debug_stepper.TIMES)
    pos = jax.jit(jtraj.se2_pos)
    rows = []
    for i in range(0, n_valid, debug_stepper.EVERY):
        c_xy, ts_xy, c_yaw, ts_yaw, T = jalm._coeffs(
            jnp.asarray(rec["x"][i]), bound, shape)
        tr = jtraj.SE2Traj(c_xy=c_xy, ts_xy=ts_xy, c_yaw=c_yaw,
                           ts_yaw=ts_yaw)
        for uu in u:
            p = np.asarray(pos(tr, jnp.asarray(uu * float(T))))
            rows.append((i, float(rec["f"][i]), uu * float(T),
                         p[0], p[1], p[2]))
    return rec, rows


def _stepper_record(rec, rows):
    """(counts [1, C], values) of a stepper run for the envelope: each
    evaluation's round, iteration and validity and each CSV row's
    evaluation; the iterates, the values and the CSV's columns."""
    rows = np.asarray(rows, np.float64)
    counts = np.concatenate([rec["outer"], rec["inner"], rec["valid"],
                             rows[:, 0]]).astype(np.int64)
    values = {"x": rec["x"], "f": rec["f"], "csv_f": rows[:, 1],
              "csv_pose": rows[:, 2:]}
    return counts[None], {k: np.asarray(v, np.float64)[None]
                          for k, v in values.items()}


def test_debug_stepper_csv_matches_jax(tmp_path):
    """debug_stepper's recorded evaluations and its CSV against
    examples/debug_stepper.py's on the same fixed path, held to JAX's
    envelope on this host (torch_parity.jax_envelope: the JAX stepper at
    x0 and at x0 (1 +- 1e-15)): round, iteration and validity rows and the
    CSV's evaluation column equal those of the JAX runs; iterates and the
    pose columns within their range widened by max(1e-8, 10 x spread),
    values and the fval column by max(1e-10 of the lane's largest value,
    10 x spread).  JAX's own values at x0 and x0 (1 +- 1e-15) spread by
    4.3e-10 of the largest and move with OMP_NUM_THREADS (on an AMD EPYC
    host), so no fixed bound at 1e-10 holds them."""
    out = str(tmp_path / "debug.csv")
    got = debug_stepper.run(TEST_CFG, out=out, device="cpu",
                            dtype=np.float64, log=lambda s: None)
    jg = jgrid.with_pair_table(jhill(
        JMapConfig(xy_resolution=0.2, yaw_resolution=0.45),
        dtype=np.float64))
    runs = []

    def jax_stepper(s):
        runs.append(_jax_stepper_rows(jg, float(s[0])))
        return runs[-1]
    env = jax_envelope(jax_stepper, np.ones(1),
                       read=lambda r: _stepper_record(*r), wrap=np.asarray)
    rec, rows = runs[0]
    assert rec["valid"].sum() >= 1
    with open(out) as f:
        table = list(csv.reader(f))
    assert table[0] == debug_stepper.COLUMNS.split(",")
    body = np.asarray(table[1:], np.float64)
    assert body.shape == np.shape(rows) == (len(got.rows), 6)
    f_tol = TOL_ROWS_F * np.abs(rec["f"]).max()
    assert_in_envelope(env, *_stepper_record(got.rec, body),
                       floor={"x": TOL_ROWS_X, "f": f_tol, "csv_f": f_tol,
                              "csv_pose": TOL_ROWS_X})


def test_build_maps_on_a_sampled_cloud(tmp_path):
    """build_maps on a hill cloud written as maps/hill.pcd (the surface
    samples of tests/test_torch_build.py's cloud): the C++ reader gives
    the JAX example's cloud, the map equals the JAX package's build of it
    within tests/test_torch_build.py's tolerances, the npz holds the map,
    and the reference CSV read back by the C++ equals it to 1e-12."""
    from test_torch_build import hill_mesh
    maps = tmp_path / "maps"
    maps.mkdir()
    raw = mesh.sample_surface(*hill_mesh(), 30_000, seed=0)
    mesh.save_pcd(str(maps / "hill.pcd"), raw)
    lines = []
    got = build_maps.build_scene("hill", BUILD_CFG, out=str(tmp_path),
                                 csv=True, maps_dir=str(maps), device="cpu",
                                 log=lines.append)
    assert len(lines) == 3 and lines[0].startswith("[hill] ")
    cloud = jnative.pcd_load(str(maps / "hill.pcd"))
    assert got.n_points == len(cloud)
    np.testing.assert_array_equal(native.pcd_load(str(maps / "hill.pcd")),
                                  cloud)
    want = np.asarray(jbuild.construct_map(
        cloud, JMapConfig(xy_resolution=0.4, yaw_resolution=0.8),
        chunk=8192).data, np.float64)
    data = got.grid.data.numpy()
    d = np.abs(data.astype(np.float64) - want)
    assert d.max() <= TOL_CELL and np.median(d) <= TOL_MEDIAN, d.max()
    np.testing.assert_array_equal(io.load_map_npz(got.npz), data)
    back = native.map_csv_read(got.csv, got.grid.voxel_num)
    np.testing.assert_allclose(back, data, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["plan_demo", "debug_stepper",
                                  "build_maps"])
def test_entry_points_run_as_modules(name):
    """`python -m uneven_planner_tpu_torch.examples.<name> --help` parses
    its arguments, `--device` among them, without JAX."""
    r = subprocess.run(
        [sys.executable, "-m", f"uneven_planner_tpu_torch.examples.{name}",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout
