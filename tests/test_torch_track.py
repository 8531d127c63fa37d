"""Port parity of the closed loop with the JAX package (f64, CPU): the
plant, the batched rollout against `vmap(track_trajectory)`, and the
plan -> track pipeline as a whole against `vmap(plan_track_scenario)` on the
coarse hill grid."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.config import MPCConfig as JMPCConfig
from uneven_planner_tpu.config import scene_config as jscene_config
from uneven_planner_tpu.mpc import traj_msg as jmsg
from uneven_planner_tpu.parallel import pipeline as jpipeline
from uneven_planner_tpu.sim import rollout as jrollout
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu.terrain.synthetic import make_synthetic_grid
from uneven_planner_tpu_torch import convert
from uneven_planner_tpu_torch.config import MPCConfig, scene_config
from uneven_planner_tpu_torch.minco.traj import expand_traj
from uneven_planner_tpu_torch.mpc import tracker, traj_msg
from uneven_planner_tpu_torch.parallel import pipeline
from uneven_planner_tpu_torch.sim import rollout
from uneven_planner_tpu_torch.solver import alm as talm

from torch_parity import CPU, TEST_CFG, plan_scenarios, port_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t = torch.tensor


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """The CPU loops of these tests are thousands of tiny tensor operations,
    where PyTorch's thread pool only adds hand-off cost (4x on a busy
    machine): run them on one thread and put the setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f8_starts(n, seed):
    """Perturbed start states on the figure-eight, as the JAX package's MPC
    benchmark draws them."""
    rng = np.random.default_rng(seed)
    s0 = np.zeros((n, 3))
    s0[:, 0] = rng.uniform(-0.05, 0.05, size=n)
    s0[:, 1] = rng.uniform(-0.05, 0.05, size=n)
    s0[:, 2] = np.pi / 4 + rng.uniform(-0.1, 0.1, size=n)
    return s0


# ---------------------------------------------------------------------------
# plant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", [tracker.DIFF, tracker.ACKER])
def test_plant_steps_match_jax(model):
    jc, tc = JMPCConfig(model_type=model), MPCConfig(model_type=model)
    rng = np.random.default_rng(model)
    state, act = rng.normal(size=(4, 3)), rng.normal(size=(4, 2)) * 0.2
    cmd = rng.normal(size=(4, 2)) * 0.3
    valid = np.array([True, False, True, True])
    each = lambda fn, *a: [fn(*(jnp.asarray(x[b]) for x in a))
                           for b in range(4)]
    want = each(lambda s, c, v: jrollout.plant_step(s, c, jc, 0.01, v),
                state, cmd, valid)
    got = rollout.plant_step(t(state), t(cmd), tc, 0.01, t(valid))
    for b in range(4):                                   # 1e-14
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want[b]),
                                   atol=1e-14)
    assert torch.equal(rollout.plant_step(t(state), t(cmd), tc, 0.01)[0],
                       got[0])
    jp = jrollout.PlantParams(slip_lon=0.05, slip_lat=0.02, v_tau=0.05,
                              steer_tau=0.03)
    tp = rollout.PlantParams(*jp)
    want = each(lambda s, a, c, v: jrollout.plant_step_physical(
        s, a, c, jc, 0.01, jp, v), state, act, cmd, valid)
    gs, ga = rollout.plant_step_physical(t(state), t(act), t(cmd), tc, 0.01,
                                         tp, t(valid))
    for b in range(4):
        np.testing.assert_allclose(gs[b].numpy(), np.asarray(want[b][0]),
                                   atol=1e-14)
        np.testing.assert_allclose(ga[b].numpy(), np.asarray(want[b][1]),
                                   atol=1e-14)
    # all-zero parameters are the ideal plant
    zs, _ = rollout.plant_step_physical(t(state), torch.zeros(4, 2).double(),
                                        t(cmd), tc, 0.01,
                                        rollout.PlantParams())
    torch.testing.assert_close(zs, rollout.plant_step(t(state), t(cmd), tc,
                                                      0.01),
                               rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------

N_TICKS = 40
CUT = dict(qp_scan_iters=80)     # keeps the CPU loops light


@pytest.fixture(scope="module")
def f8_tracked():
    """3 lanes x 40 ticks on the figure-eight in both packages."""
    jc, tc = JMPCConfig(**CUT), MPCConfig(**CUT)
    s0 = _f8_starts(3, 3)
    jf8 = jmsg.figure_eight(0.5)
    want = jax.jit(jax.vmap(lambda s: jrollout.track_trajectory(
        jf8, s, jc, n_steps=N_TICKS, max_sqp_iter=3)))(jnp.asarray(s0))
    f8 = traj_msg.figure_eight(0.5, device=CPU)
    got = rollout.track_trajectory_batched(f8, s0, tc, N_TICKS, device=CPU)
    return s0, f8, tc, jax.tree.map(np.asarray, want), got


def test_batched_rollout_matches_vmap_of_jax_track_trajectory(f8_tracked):
    """Commands and states within 1e-6 over the episode (1e-12 in practice:
    no discrete choice sits at a threshold in this episode)."""
    _, _, _, want, got = f8_tracked
    assert got.states.shape == (3, N_TICKS, 3)
    assert got.cmds.shape == (3, N_TICKS, 2)
    for name in ("states", "cmds", "errs", "mean_err"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(got.at_goal.numpy(), want.at_goal)
    assert torch.isfinite(got.states).all()
    assert (got.mean_err < 0.06).all()
    # diagnostics of the QP passes
    assert (got.sqp_iters >= 1).all() and (got.sqp_iters <= 3).all()
    assert (got.qp_iters_max <= 80).all() and not got.qp_failed.any()
    assert (got.qp_capped <= got.sqp_iters).all()
    carried = convert.track_result_from_numpy(want, device=CPU)
    assert carried.states.shape == (3, N_TICKS, 3)
    assert carried.qp_iters is None
    # the rollout carry of one JAX lane is the port's carry of a batch of one
    s0, _, tc, _, _ = f8_tracked
    jinit = jrollout._roll_init(jnp.asarray(s0[0]), JMPCConfig(**CUT),
                                jnp.float64)
    carry = convert.roll_state_from_numpy(jax.tree.map(np.asarray, jinit),
                                          device=CPU)
    for a, b in zip(carry, rollout.roll_init(t(s0[:1]), tc)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_full_qp_rollout_matches_vmap_of_jax_track_trajectory():
    """The full QP (`qp_condense=False`, states and inputs as variables),
    horizon 8: 2 lanes x 10 ticks of the figure-eight in both packages,
    f64.  States within 1e-12 and commands within 1e-10, as the condensed
    rollout holds in practice: the QP's 1e-6 test decides the same
    iteration on both sides, so the two differ by the order of their
    products' sums only."""
    kw = dict(qp_condense=False, predict_steps=8)
    jc, tc = JMPCConfig(**kw), MPCConfig(**kw)
    s0 = _f8_starts(2, 11)
    want = jax.jit(jax.vmap(lambda s: jrollout.track_trajectory(
        jmsg.figure_eight(0.5), s, jc, n_steps=10, max_sqp_iter=3)))(
            jnp.asarray(s0))
    want = jax.tree.map(np.asarray, want)
    got = rollout.track_trajectory_batched(
        traj_msg.figure_eight(0.5, device=CPU), s0, tc, 10, device=CPU)
    assert got.states.shape == (2, 10, 3)
    np.testing.assert_allclose(got.states.numpy(), want.states, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.cmds.numpy(), want.cmds, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.mean_err.numpy(), want.mean_err, rtol=0,
                               atol=1e-12)
    assert not got.qp_failed.any() and (got.mean_err < 0.06).all()
    assert (got.qp_iters_max <= tc.qp_scan_iters).all()


def test_track_trajectory_is_a_batch_of_one(f8_tracked):
    s0, f8, tc, _, got = f8_tracked
    one = rollout.track_trajectory(f8, s0[1], tc, 12, device=CPU)
    assert one.states.shape == (1, 12, 3)
    # one lane alone and in a batch of 3 differ only as two batch widths of
    # the CPU GEMM do
    torch.testing.assert_close(one.cmds[0], got.cmds[1, :12], rtol=0,
                               atol=1e-9)


def test_per_lane_trajectories_and_slip_plant_match_jax():
    """`traj_batched`: every lane its own trajectory, against the slip/lag
    plant; the JAX package is run lane by lane."""
    jc, tc = JMPCConfig(**CUT), MPCConfig(**CUT)
    jp = jrollout.PlantParams(slip_lon=0.05, slip_lat=0.02, v_tau=0.05,
                              steer_tau=0.05)
    s0 = _f8_starts(2, 5)
    jtrajs = [jmsg.figure_eight(0.5), jmsg.figure_eight(0.4, radius=1.0)]
    want = [jax.jit(lambda s, q=q: jrollout.track_trajectory(
        q, s, jc, n_steps=15, max_sqp_iter=2, plant_params=jp))(
        jnp.asarray(s0[b])) for b, q in enumerate(jtrajs)]
    trajs = convert.traj_from_numpy(
        jax.tree.map(lambda *a: np.stack(a), *jtrajs), device=CPU)
    got = rollout.track_trajectory_batched(
        trajs, s0, tc, 15, max_sqp_iter=2,
        plant_params=rollout.PlantParams(*jp), traj_batched=True,
        device=CPU)
    for b in range(2):
        np.testing.assert_allclose(got.states[b].numpy(),
                                   np.asarray(want[b].states), atol=1e-6)
        np.testing.assert_allclose(got.cmds[b].numpy(),
                                   np.asarray(want[b].cmds), atol=1e-6)
    with pytest.raises(ValueError):
        rollout.track_trajectory_batched(trajs, s0[:1], tc, 2,
                                         traj_batched=True, device=CPU)
    with pytest.raises(ValueError):
        rollout.track_trajectory_batched(trajs, s0, tc, 2, device=CPU)


def test_at_goal_zeroes_the_command_and_mean_err_counts_pre_goal_ticks():
    """Past duration + 1 s the command is zero though the MPC still runs;
    `mean_err` averages the ticks before that only."""
    tc = MPCConfig(qp_scan_iters=40)
    f8 = traj_msg.figure_eight(0.5, device=CPU)
    dur = float(f8.total_duration[0])
    s = rollout.roll_init(torch.zeros((2, 3), dtype=torch.float64), tc)
    s = s._replace(t=t([dur + 0.995, 0.0]).double())
    lanes = expand_traj(f8, 2)
    seen = []
    for _ in range(3):
        s, (_, cmd, err, at_goal), res = rollout.tick(lanes, s, tc, 0.01,
                                                       1, None)
        seen.append((cmd, at_goal, res.cmd))
    assert [bool(a[0]) for _, a, _ in seen] == [False, True, True]
    assert not any(bool(a[1]) for _, a, _ in seen)
    for cmd, at_goal, raw in seen[1:]:
        assert not cmd[0].any() and raw[0].abs().max() > 0
    errs = t([[1.0, 3.0, 100.0]]).double()
    at = t([[False, False, True]])
    mean = (errs * ~at).sum(1) / (~at).sum(1).clamp(min=1)
    assert float(mean) == 2.0


# ---------------------------------------------------------------------------
# the pipeline as a whole
# ---------------------------------------------------------------------------

SIZING = dict(frontier_size=128, max_rounds=60)
OVR = {"mem_size": 8, "max_iterations": 40}
TRACK_TICKS = 40


def _scene(make):
    cfg = make("hill")
    return dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, xy_resolution=0.2,
                                     yaw_resolution=0.45),
        frontend=dataclasses.replace(cfg.frontend, **SIZING))


@pytest.fixture(scope="module")
def piped():
    """2 scenarios through `vmap(plan_track_scenario)` and through the
    port's `plan_track_batch` (coarse grid, small frontier, 40 ticks)."""
    jcfg, tcfg = _scene(jscene_config), _scene(scene_config)
    jg = make_synthetic_grid(TEST_CFG)
    starts, goals = (a[1:3] for a in plan_scenarios(4, seed=20))
    jshape = jalm.ProblemShape(6, 12, 8)
    want = jax.jit(lambda s, g: jpipeline.plan_track_batch(
        jg, jcfg, s, g, jshape, n_track_steps=TRACK_TICKS,
        lbfgs_overrides=OVR))(jnp.asarray(starts), jnp.asarray(goals))
    tg = port_grid(jg)
    got = pipeline.plan_track_batch(
        tg, tcfg, starts, goals, talm.ProblemShape(6, 12, 8),
        n_track_steps=TRACK_TICKS, lbfgs_overrides=OVR, device=CPU)
    return tg, tcfg, starts, goals, jax.tree.map(np.asarray, want), got


def test_plan_track_batch_matches_vmap_of_jax_plan_track_scenario(piped):
    """Lane for lane the same flags.  The ALM optimum is flat at its 1e-3
    tolerance, so the solved trajectory repeats between the packages only
    as far as the JAX package repeats itself under a 1-ulp change (see
    tests/torch_parity.py); a lane whose solve ran the same iterations in
    both is held to 1e-5 in its tracking errors and 1e-3 in its trajectory,
    every lane to the ALM tolerance band (5e-3)."""
    _, _, _, _, want, got = piped
    np.testing.assert_array_equal(got.plan_success.numpy(), want.plan_success)
    np.testing.assert_array_equal(got.alm_converged.numpy(),
                                  want.alm_converged)
    assert want.plan_success.all() and want.alm_converged.all()
    stable = (got.inner_iters.numpy() == want.inner_iters) \
        & (got.outer_iters.numpy() == want.outer_iters)
    for name, tol in (("mean_track_err", 1e-5), ("final_track_err", 1e-5),
                      ("non_hol", 1e-3), ("res_h", 1e-4), ("res_g", 1e-4)):
        a, b = getattr(got, name).numpy(), getattr(want, name)
        np.testing.assert_allclose(a[stable], b[stable], rtol=0, atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(got.traj.c_xy.numpy()[stable],
                               want.traj.c_xy[stable], atol=1e-3)
    np.testing.assert_allclose(got.mean_track_err.numpy(),
                               want.mean_track_err, atol=5e-3)
    np.testing.assert_allclose(got.final_track_err.numpy(),
                               want.final_track_err, atol=5e-3)
    assert (got.mean_track_err < 0.05).all()
    assert got.track.states.shape == (2, TRACK_TICKS, 3)
    carried = convert.pipeline_result_from_numpy(want, device=CPU)
    assert carried.traj.c_xy.shape == got.traj.c_xy.shape
    assert carried.track is None


def test_tracking_stage_is_exact_on_the_jax_trajectories(piped):
    """Given the trajectories the JAX package tracked (after its wire round
    trip), the port's closed loop repeats its tracking errors within 1e-6,
    whatever the solve before it did."""
    _, tcfg, starts, _, want, _ = piped
    trajs = convert.traj_from_numpy(want.traj, device=CPU)
    tres = rollout.track_trajectory_batched(
        trajs, starts, tcfg.mpc, TRACK_TICKS, traj_batched=True, device=CPU)
    np.testing.assert_allclose(tres.mean_err.numpy(), want.mean_track_err,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tres.errs[:, -1].numpy(),
                               want.final_track_err, rtol=0, atol=1e-6)


def test_plan_track_scenario_is_a_batch_of_one(piped):
    tg, tcfg, starts, goals, _, got = piped
    one = pipeline.plan_track_scenario(
        tg, tcfg, starts[1], goals[1], talm.ProblemShape(6, 12, 8),
        n_track_steps=5, lbfgs_overrides=OVR, device=CPU)
    assert one.plan_success.shape == (1,) and bool(one.plan_success[0])
    assert bool(one.alm_converged[0]) == bool(got.alm_converged[1])
    assert (one.track.cmds[0] - got.track.cmds[1, :5]).abs().max() < 2e-2


def test_entry_points_default_to_cuda_and_raise_without_it(piped,
                                                           monkeypatch):
    tg, tcfg, starts, goals, _, _ = piped
    f8 = traj_msg.figure_eight(0.5, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.plan_track_batch(tg, tcfg, starts, goals,
                                  talm.ProblemShape(6, 12, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        rollout.track_trajectory_batched(f8, _f8_starts(2, 0), tcfg.mpc, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        traj_msg.figure_eight(0.5)


def test_tracking_modules_import_no_jax():
    mods = ["uneven_planner_tpu_torch.parallel.pipeline",
            "uneven_planner_tpu_torch.sim.rollout",
            "uneven_planner_tpu_torch.mpc.tracker",
            "uneven_planner_tpu_torch.mpc.traj_msg",
            "uneven_planner_tpu_torch.solver.admm_qp",
            "uneven_planner_tpu_torch.kernels.admm",
            "uneven_planner_tpu_torch.kernels.elementwise",
            "uneven_planner_tpu_torch.minco.banded",
            "uneven_planner_tpu_torch.convert"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'uneven_planner_tpu', 'triton')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
