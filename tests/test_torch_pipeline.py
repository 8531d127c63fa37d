"""The port's slice as a whole: the headline batch, the compacted solve
with nearest-pilot warm duals against the JAX package lane by lane, the
state converters, and the package's import and device rules.  The compacted
solve's knobs are tested in tests/test_torch_compaction.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from uneven_planner_tpu.config import scene_config as jscene_config
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu_torch import headline
from uneven_planner_tpu_torch.config import scene_config
from uneven_planner_tpu_torch.solver import alm as talm
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

from torch_parity import (CPU, TEST_CFG, assert_in_envelope, jax_envelope,
                          jax_grid, port_grid, read_alm, to_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the ALM band: the JAX package holds its own flat and nested solves of one
# problem to it (tests/test_alm.py:309, :408)
TOL_BAND = 2e-2
HC = headline.HeadlineConfig(batch=16, pilot=16, piece_xy=6, piece_yaw=12,
                             int_K=8, chunk_steps=32, buckets=(1, 4),
                             max_dispatch=16, retry_width=None)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """One PyTorch thread, then the setting back: the pilot solve that
    harvests the warm duals sums in an order that follows the thread
    count, so one thread gives every host the same duals, and the suite's
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    jg = jax_grid()
    return jg, port_grid(jg)


def test_make_batch_matches_bench():
    shape = HC.shape
    want_x, want_b, want_f = bench.make_batch(
        12, jscene_config("hill"), jalm.ProblemShape(6, 12, 8),
        np.random.default_rng(3))
    got_x, got_b, got_f = headline.make_batch(
        12, scene_config("hill"), shape, np.random.default_rng(3),
        device=CPU)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    for f in talm.Boundary._fields:
        np.testing.assert_array_equal(getattr(got_b, f).numpy(),
                                      np.asarray(getattr(want_b, f)))
    np.testing.assert_array_equal(got_f, want_f)


def test_compacted_warm_solve_matches_jax_lane_by_lane(grids):
    """16 headline-style lanes with warm duals from a 16-lane pilot (the
    port's harvest), solved by both packages' compacted solves.  All 16
    lanes are held to JAX's envelope on this host (torch_parity.
    jax_envelope): the lanes whose counts move when x0 moves by up to
    1e-13 (6 of 16 on an AMD EPYC host, one of them in 40 count groups
    over 131 runs) get RUNS_PER_LANE more JAX runs each at 1-ulp
    perturbations of x0, drawn without regard to the port's result; each
    lane's counts must be those of one JAX run and its x within the range
    of those runs, widened by max(1e-8, 10 x JAX's 1-ulp spread).  Every lane's x also lies within
    the ALM band (TOL_BAND) of JAX's run at x0."""
    jg, tg = grids
    cfg = scene_config("hill")
    rng = np.random.default_rng(0)
    warm_for = headline.harvest_warm(cfg, tg, HC, rng, device=CPU)
    assert warm_for is not None
    x0, bnd, feats = headline.make_batch(HC.batch, cfg, HC.shape, rng,
                                         device=CPU)
    # the parity solve runs in f64, as the JAX package's tests do
    f64 = lambda a: a.double()
    x0, bnd = f64(x0), talm.tree_map(f64, bnd)
    warm = talm.tree_map(f64, warm_for(feats))
    res = headline.solve(x0, bnd, cfg, tg, HC, warm_duals=warm)

    jwarm = jalm.DualState(*(a.numpy() for a in warm))
    jb = jalm.Boundary(*(a.numpy() for a in bnd))

    def run(x, b, w):
        return jalm.solve_flat_compacted(
            x, b, jalm.ProblemShape(6, 12, 8), jg, jscene_config("hill").alm,
            lbfgs_overrides=HC.overrides, chunk_steps=HC.chunk_steps,
            buckets=HC.buckets, max_dispatch=HC.max_dispatch,
            retry_width=None, warm_duals=w)
    counts, values = read_alm(res)
    env = jax_envelope(run, x0.numpy(), to_jax(jb), to_jax(jwarm),
                       lanes=True)
    assert_in_envelope(env, counts, values)
    dx = np.abs(values["x"] - env.at_x0("x")).max(1)
    assert (dx < TOL_BAND).all(), dx
    assert res.converged.float().mean() >= 0.9


def test_grid_from_jax_tables_equals_port_tables(grids):
    jg, tg = grids
    conv = port_grid(jg, tables_from_jax=True)
    for name in ("data", "occ", "occ_xy", "data_pair", "data_packed16"):
        assert torch.equal(getattr(conv, name), getattr(tg, name)), name
    assert conv.origin == tg.origin
    assert conv.voxel_num == tg.voxel_num


def test_port_imports_no_jax():
    mods = ["uneven_planner_tpu_torch", "uneven_planner_tpu_torch.config",
            "uneven_planner_tpu_torch.convert",
            "uneven_planner_tpu_torch.headline",
            "uneven_planner_tpu_torch.manager",
            "uneven_planner_tpu_torch.kernels.terrain_lookup",
            "uneven_planner_tpu_torch.minco.traj",
            "uneven_planner_tpu_torch.minco.uniform",
            "uneven_planner_tpu_torch.solver.alm",
            "uneven_planner_tpu_torch.solver.lbfgs",
            "uneven_planner_tpu_torch.terrain.grid",
            "uneven_planner_tpu_torch.terrain.synthetic"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'uneven_planner_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_modules_import_no_jax():
    """Every module of the package (found by walking it, the examples and
    the host oracles included) and chip_smoke.py import neither JAX nor
    the JAX package."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import uneven_planner_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in names: importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'uneven_planner_tpu')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 50 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for name in ("utils.native", "utils.qp_ref", "examples.plan_demo",
                 "examples.debug_stepper", "examples.build_maps"):
        assert os.path.exists(os.path.join(
            REPO, "uneven_planner_tpu_torch", *name.split(".")) + ".py")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    from uneven_planner_tpu_torch.bench import scaling
    from uneven_planner_tpu_torch.examples import (build_maps,
                                                   debug_stepper, plan_demo)
    from uneven_planner_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_synthetic_grid(TEST_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        headline.scene_setup(TEST_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        headline.make_batch(2, scene_config("hill"), HC.shape,
                            np.random.default_rng(0))
    # forks nothing: the device is resolved before any process starts
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.launch_local("raise SystemExit(3)", num_processes=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling.run_multiprocess(1, 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_demo.run(TEST_CFG, cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        debug_stepper.run(TEST_CFG, out=str(tmp_path / "d.csv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_maps.build_scene("hill", TEST_CFG, out=str(tmp_path),
                               maps_dir=str(tmp_path))
