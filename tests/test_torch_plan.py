"""Port parity of the planning path as a whole: trajectory evaluation and
post-solve metrics, and `api.plan_batch` (search -> on-device init guess ->
flat solve) against `jax.vmap(api.plan)` of the JAX package (f64, coarse
hill grid)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu import api as japi
from uneven_planner_tpu import manager as jmanager
from uneven_planner_tpu.config import scene_config as jscene_config
from uneven_planner_tpu.minco import minco as jminco
from uneven_planner_tpu.minco import traj as jtraj
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu_torch import api, convert
from uneven_planner_tpu_torch.config import scene_config
from uneven_planner_tpu_torch.minco import minco, traj
from uneven_planner_tpu_torch.solver import alm as talm

from torch_parity import (CPU, assert_lanes_match, assert_paths_valid,
                          jax_grid, lane_stability, plan_scenarios, port_grid)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZING = dict(frontier_size=128, max_rounds=60)
JSHAPE = jalm.ProblemShape(6, 12, 8)
TSHAPE = talm.ProblemShape(6, 12, 8)
OVR = {"mem_size": 8, "max_iterations": 40}


def _scene(make):
    cfg = make("hill")
    return dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, xy_resolution=0.2,
                                     yaw_resolution=0.45),
        frontend=dataclasses.replace(cfg.frontend, **SIZING))


JCFG, TCFG = _scene(jscene_config), _scene(scene_config)


@pytest.fixture(scope="module")
def grids():
    jg = jax_grid()
    return jg, port_grid(jg)


@pytest.fixture(scope="module")
def planned(grids):
    """4 scenarios through `vmap(api.plan)` and through `plan_batch`."""
    jg, tg = grids
    starts, goals = plan_scenarios(4, seed=20)
    ref_k, ref_a = jax.jit(jax.vmap(lambda s, g: japi.plan(
        jg, JCFG, s, g, shape=JSHAPE, lbfgs_overrides=OVR)))(
        jnp.asarray(starts), jnp.asarray(goals))
    got_k, got_a = api.plan_batch(tg, TCFG, starts, goals, shape=TSHAPE,
                                  lbfgs_overrides=OVR, device=CPU)
    return starts, goals, jax.tree.map(np.asarray, ref_k), ref_a, got_k, got_a


def test_plan_batch_matches_vmap_of_jax_plan(grids, planned):
    jg, tg = grids
    starts, goals, ref_k, ref_a, got_k, got_a = planned
    np.testing.assert_array_equal(got_k.success.numpy(), ref_k.success)
    assert ref_k.success.all()
    np.testing.assert_array_equal(got_k.rounds.numpy(), ref_k.rounds)
    np.testing.assert_allclose(got_k.cost.numpy(), ref_k.cost, rtol=1e-6)
    assert_paths_valid(tg, got_k.path.numpy(), got_k.path_mask.numpy(),
                       got_k.success.numpy(), starts, goals,
                       TCFG.frontend.max_vel * TCFG.frontend.time_interval)

    # which lanes of the JAX solve are stable under a 1-ulp change of x0
    x0, bnd = jax.vmap(lambda p, m: jmanager.init_guess_fixed_jax(
        p, m, JCFG.manager, JSHAPE.piece_xy, JSHAPE.piece_yaw))(
        jnp.asarray(ref_k.path), jnp.asarray(ref_k.path_mask))
    run = jax.jit(jax.vmap(lambda x, b: jalm.solve_flat(
        x, b, JSHAPE, jg, JCFG.alm, lbfgs_overrides=OVR)))
    ref, stable, spread = lane_stability(run, np.asarray(x0), bnd)
    # the fused program rounds x0 differently from its pieces run apart,
    # so only stable lanes repeat their counts
    np.testing.assert_array_equal(np.asarray(ref.evals)[stable],
                                  np.asarray(ref_a.evals)[stable])
    assert_lanes_match(ref_a, got_a, stable, spread, min_stable=3)
    assert got_a.converged.all()
    assert got_a.x.shape == (4, TSHAPE.num_vars)
    assert torch.isfinite(got_a.traj.c_xy).all()


def test_plan_is_a_batch_of_one(grids, planned):
    _, tg = grids
    starts, goals, _, _, got_k, got_a = planned
    k1, a1 = api.plan(tg, TCFG, starts[2], goals[2], shape=TSHAPE,
                      lbfgs_overrides=OVR, device=CPU)
    assert k1.success.shape == (1,) and bool(k1.success[0])
    torch.testing.assert_close(k1.path[0], got_k.path[2], rtol=0, atol=0)
    assert bool(a1.converged[0]) == bool(got_a.converged[2])
    # one lane alone and the same lane in a batch of 4 differ only as two
    # batch widths of the CPU GEMM do (tests/torch_parity.py)
    assert (a1.x[0] - got_a.x[2]).abs().max() < 2e-2


def test_failed_search_does_not_poison_the_batch(grids, planned):
    """A scenario with no path still goes through the solve (as in the JAX
    package) and leaves the other lanes as they are."""
    _, tg = grids
    starts, goals, _, _, _, got_a = planned
    goals = goals.copy()
    goals[1] = [20.0, 20.0, 0.0]
    k, a = api.plan_batch(tg, TCFG, starts, goals, shape=TSHAPE,
                          lbfgs_overrides=OVR, device=CPU)
    assert k.success.tolist() == [True, False, True, True]
    keep = [0, 2, 3]
    assert torch.isfinite(a.x[keep]).all()
    np.testing.assert_array_equal(a.converged[keep].numpy(),
                                  got_a.converged[keep].numpy())
    assert (a.x[keep] - got_a.x[keep]).abs().max() < 2e-2


# ---------------------------------------------------------------------------
# trajectory evaluation and metrics on the solved trajectories
# ---------------------------------------------------------------------------

def _times(ref_a, n=64):
    dur = np.asarray(jnp.minimum(ref_a.traj.ts_xy.sum(-1),
                                 ref_a.traj.ts_yaw.sum(-1)))
    t = np.linspace(-0.2, 1.1, n)[None, :] * dur[:, None]   # both ends passed
    t[:, 7] = np.asarray(jnp.cumsum(ref_a.traj.ts_xy, -1))[:, 2]  # a knot
    return t


def test_eval_traj_matches_jax(planned):
    ref_a = planned[3]
    tr = convert.traj_from_numpy(jax.tree.map(np.asarray, ref_a.traj),
                                 device=CPU)
    t = _times(ref_a)
    for c, ts, tc, tts in ((ref_a.traj.c_xy, ref_a.traj.ts_xy, tr.c_xy,
                            tr.ts_xy),
                           (ref_a.traj.c_yaw, ref_a.traj.ts_yaw, tr.c_yaw,
                            tr.ts_yaw)):
        want = jax.vmap(lambda ci, tsi, ti: jax.vmap(
            lambda one: jminco.eval_traj(ci, tsi, one))(ti))(
            c, ts, jnp.asarray(t))
        got = minco.eval_traj(tc, tts, torch.tensor(t))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9)
        idx_w, s_w = jax.vmap(lambda tsi, ti: jminco.locate_piece(
            jnp.cumsum(tsi), ti))(ts, jnp.asarray(t))
        idx, s = minco.locate_piece(torch.cumsum(tts, 1), torch.tensor(t))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_w), atol=1e-12)


def test_post_solve_metrics_match_jax(grids, planned):
    jg, tg = grids
    ref_a, got_a = planned[3], planned[5]
    jt = ref_a.traj
    tr = convert.traj_from_numpy(jax.tree.map(np.asarray, jt), device=CPU)
    n = 2048
    each = lambda fn: jax.jit(jax.vmap(fn))(jt)
    np.testing.assert_allclose(
        traj.non_hol_error(tr, n).numpy(),
        np.asarray(each(lambda q: jtraj.non_hol_error(q, n))), rtol=1e-9,
        atol=1e-9)
    np.testing.assert_allclose(
        traj.max_vel_rate(tr, n).numpy(),
        np.asarray(each(lambda q: jtraj.max_vel_rate(q, n))), rtol=1e-9,
        atol=1e-9)
    want = each(lambda q: jtraj.max_metrics(q, jg, n))
    got = traj.max_metrics(tr, tg, n)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    # a converged solve respects the bounds it was solved under (sampled
    # more densely here than the constraints were)
    m = traj.max_metrics(got_a.traj, tg, n)
    assert (m["max_sig"] <= TCFG.alm.max_sig * 1.05).all()
    assert (m["min_cxi"] >= TCFG.alm.min_cxi * 0.99).all()
    assert (traj.non_hol_error(got_a.traj, n) < 1.0).all()


def test_state_samplers_match_jax(planned):
    ref_a = planned[3]
    jt = ref_a.traj
    tr = convert.traj_from_numpy(jax.tree.map(np.asarray, jt), device=CPU)
    poses_w, mask_w = jax.vmap(lambda q: jtraj.sample_dense(q, 300, 0.05))(jt)
    poses, mask = traj.sample_dense(tr, 300, 0.05)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_w))
    np.testing.assert_allclose(poses.numpy(), np.asarray(poses_w), atol=1e-9)
    assert mask.any() and not mask.all()
    t = _times(ref_a, 16)
    st_w = jax.vmap(lambda q, ti: jax.vmap(
        lambda one: jtraj.se2_state(q, one))(ti))(jt, jnp.asarray(t))
    st = traj.se2_state(tr, torch.tensor(t))
    for g, w in zip(st, st_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)
    pos, vel, acc, yaw, dyaw, _ = st
    cur_w = jax.vmap(jax.vmap(jtraj.curvature))(st_w[1], st_w[3], st_w[4])
    np.testing.assert_allclose(traj.curvature(vel, yaw, dyaw).numpy(),
                               np.asarray(cur_w), atol=1e-9)
    la_w = jax.vmap(jax.vmap(jtraj.lon_lat_acc))(st_w[2], st_w[3])
    for g, w in zip(traj.lon_lat_acc(acc, yaw), la_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)
    np.testing.assert_allclose(
        traj.se2_pos(tr, torch.tensor(t)).numpy(),
        np.concatenate([np.asarray(st_w[0]), np.asarray(st_w[3])[..., None]],
                       -1), atol=1e-9)


# ---------------------------------------------------------------------------
# scenes, devices, imports
# ---------------------------------------------------------------------------

def test_load_or_build_scene_builds_hill_and_names_what_is_missing():
    scfg, g = api.load_or_build_scene("hill", device=CPU)
    assert scfg.name == "hill" and g.voxel_num == (200, 200, 64)
    assert g.data.dtype == torch.float32 and g.data_pair is None
    for name in ("desert", "forest", "vocano"):
        with pytest.raises(NotImplementedError, match=r"maps/.*\.pcd"):
            api.load_or_build_scene(name, device=CPU)
    with pytest.raises(ValueError):
        api.load_or_build_scene("nowhere", device=CPU)


def test_plan_batch_defaults_to_cuda_and_raises_without_it(grids,
                                                            monkeypatch):
    _, tg = grids
    starts, goals = plan_scenarios(2, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.plan_batch(tg, TCFG, starts, goals)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.plan(tg, TCFG, starts[0], goals[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load_or_build_scene("hill")


def test_planning_modules_import_no_jax():
    mods = ["uneven_planner_tpu_torch.api",
            "uneven_planner_tpu_torch.frontend.dubins",
            "uneven_planner_tpu_torch.frontend.kino_init",
            "uneven_planner_tpu_torch.kernels.build",
            "uneven_planner_tpu_torch.kernels.gather",
            "uneven_planner_tpu_torch.minco.minco",
            "uneven_planner_tpu_torch.minco.traj",
            "uneven_planner_tpu_torch.manager",
            "uneven_planner_tpu_torch.convert"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'uneven_planner_tpu', 'triton')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
