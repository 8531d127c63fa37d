"""The port against the reference's C++ arithmetic and its float64 oracles:
`uneven_planner_tpu_torch.utils.native` (the port's own binding of
native/src/uneven_host.cc, built into the package's `_build/`) held to the
port's MINCO, inner cost and its gradient, Dubins distance, search and map
IO at the tolerances of tests/test_native.py; and
`uneven_planner_tpu_torch.utils.qp_ref` held to the JAX package's copy and
to the dumped tracking QP.  All on the CPU, in float64."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from uneven_planner_tpu.utils import qp_ref as jqp_ref
from uneven_planner_tpu_torch.config import (FrontendConfig, MapConfig,
                                             MPCConfig, scene_config)
from uneven_planner_tpu_torch.frontend import dubins, kino_init
from uneven_planner_tpu_torch.minco import minco, uniform
from uneven_planner_tpu_torch.solver import admm_qp, alm
from uneven_planner_tpu_torch.terrain import io, mesh
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid
from uneven_planner_tpu_torch.utils import native, qp_ref

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Small tensor loops: one thread (see tests/test_torch_nested.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hill():
    """The full-resolution hill (0.05 m): the A* lattice dedups on map
    cells, so cells must be finer than its 0.15 m arc step."""
    return make_synthetic_grid(MapConfig(), device=CPU)


def test_library_builds_from_source_into_the_package_build_dir():
    """The binding compiles native/src/uneven_host.cc itself into `_build/`
    and never touches native/ (whose tracked library stays as it is)."""
    assert native.ensure_built()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "_build"
    assert os.path.samefile(os.path.dirname(native.SOURCE),
                            os.path.join(REPO, "native", "src"))


def test_library_is_built_by_the_system_gpp(monkeypatch):
    """The compiler is the g++ on PATH whatever CXX names (another
    toolchain's library can crash beside the system's libstdc++)."""
    import shutil
    monkeypatch.setenv("CXX", "/nonexistent/bin/g++")
    assert native.compiler() == shutil.which("g++") is not None


def test_dubins_distance_matches_cpp():
    """tests/test_native.py:43 on the port: 20 random pose pairs, 1e-9."""
    rng = np.random.default_rng(1)
    rho = 0.475
    q0 = np.concatenate([rng.uniform(-3, 3, (20, 2)),
                         rng.uniform(-np.pi, np.pi, (20, 1))], 1)
    q1 = np.concatenate([rng.uniform(-3, 3, (20, 2)),
                         rng.uniform(-np.pi, np.pi, (20, 1))], 1)
    got = dubins.distance(t64(q0), t64(q1), rho).numpy()
    want = [native.dubins_distance(a, b, rho) for a, b in zip(q0, q1)]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("N,D", [(10, 2), (20, 1), (5, 2)])
def test_minco_matches_cpp(N, D):
    """tests/test_native.py:78 on the port: `minco.generate` (batched
    block-tridiagonal solve) against the C++ generate at rtol 1e-8 / atol
    1e-9, the jerk cost at rtol 1e-9, and the uniform-time path
    (`uniform.generate_norm`, row-major, and `generate_norm_cm`) at rtol
    1e-6 / atol 5e-8 against the C++ at equal times."""
    rng = np.random.default_rng(3 + N)
    inner = rng.normal(size=(N - 1, D)) * 2.0
    ts = rng.uniform(0.2, 1.5, size=N)
    head = np.concatenate([inner[:1] - 1.0, rng.normal(size=(2, D)) * 0.3])
    tail = np.concatenate([inner[-1:] + 1.0, rng.normal(size=(2, D)) * 0.3])
    b = lambda a: t64(a)[None]
    c_port = minco.generate(b(inner), b(ts), b(head), b(tail))[0].numpy()
    c_cpp = native.minco_generate(inner, ts, head, tail)
    np.testing.assert_allclose(c_port, c_cpp, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(
        float(minco.jerk_cost(b(c_port), b(ts))[0]),
        native.minco_jerk_cost(c_cpp, ts), rtol=1e-9)

    Tp = torch.tensor([0.7], dtype=torch.float64)
    c_cpp_u = native.minco_generate(inner, np.full(N, 0.7), head, tail)
    cn = uniform.generate_norm(b(inner), Tp, b(head), b(tail), N)
    np.testing.assert_allclose(uniform.denormalize(cn, Tp)[0].numpy(),
                               c_cpp_u, rtol=1e-6, atol=5e-8)
    gt = torch.as_tensor(uniform._solve_matrix(N).T, dtype=torch.float64)
    cT = uniform.generate_norm_cm(b(inner), Tp, b(head), b(tail), gt)
    np.testing.assert_allclose(
        uniform.denormalize(uniform.coeffs_from_cm(cT, N), Tp)[0].numpy(),
        c_cpp_u, rtol=1e-6, atol=5e-8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# tests/test_native.py:115's fixture in the port (the coarse float64 hill
# with its pair table, ProblemShape(6, 12, 8), an off-init iterate, random
# duals, one lane) and the C++ forward of it: the code chip_smoke.py's
# `oracle` phase runs on the card
CS = _chip_smoke()
inner_cost_fixture = lambda seed: CS.inner_cost_fixture(seed, CPU)
cpp_inner_cost = CS.cpp_inner_cost


@pytest.mark.parametrize("seed", range(6))
def test_inner_cost_matches_cpp(seed):
    """tests/test_native.py:152 on the port: `alm.inner_cost` (the exact
    pair-table lookup) equals the C++ forward over the bare field at a
    fixed iterate, rtol 1e-9 / atol 1e-10."""
    grid, cfg, shape, x, bound, duals, scaling = inner_cost_fixture(seed)
    f_port = float(alm.inner_cost(x, bound, shape, grid, cfg.alm, duals,
                                  scaling)[0])
    f_cpp = cpp_inner_cost(grid, cfg, shape, x, bound, duals, scaling)
    np.testing.assert_allclose(f_port, f_cpp, rtol=1e-9, atol=1e-10)


def test_inner_cost_gradient_matches_cpp_central_differences():
    """tests/test_native.py:172 on the port: the autograd gradient of
    `alm.inner_cost` against float64 central differences (h = 1e-6) of
    the independent C++ forward, rtol 5e-4 / atol 5e-6 (the FD limit on a
    PHR objective with active-set kinks)."""
    grid, cfg, shape, x, bound, duals, scaling = inner_cost_fixture(1)
    xg = x.clone().requires_grad_(True)
    f = alm.inner_cost(xg, bound, shape, grid, cfg.alm, duals, scaling)
    g, = torch.autograd.grad(f.sum(), xg)
    xn = x[0].numpy()
    h = 1e-6
    g_fd = np.zeros_like(xn)
    for i in range(xn.shape[0]):
        e = np.zeros_like(xn)
        e[i] = h
        fp = cpp_inner_cost(grid, cfg, shape, xn + e, bound, duals, scaling)
        fm = cpp_inner_cost(grid, cfg, shape, xn - e, bound, duals, scaling)
        g_fd[i] = (fp - fm) / (2 * h)
    np.testing.assert_allclose(g[0].numpy(), g_fd, rtol=5e-4, atol=5e-6)


def test_inner_cost_binding_checks_sizes():
    """A mis-sized argument raises before the C++ reads past it."""
    grid, cfg, shape, x, bound, duals, scaling = inner_cost_fixture(0)
    with pytest.raises(ValueError):
        native.inner_cost(grid, cfg.alm, shape, x[:, :-1], bound, duals.lam,
                          duals.mu, 2.0, scaling.scale_cx)
    with pytest.raises(ValueError):
        native.inner_cost(grid, cfg.alm, shape, x, bound, duals.lam,
                          duals.mu[:, :-1], 2.0, scaling.scale_cx)


def test_astar_oracle_path_checks(hill):
    """tests/test_native.py:56 on the port's grid: the exact-semantics A*
    reaches the goal from the start on the hill, through free cells only,
    with every step within one arc of max_vel x time_interval."""
    fe = FrontendConfig()
    start, goal = [-3.0, -3.0, 0.0], [0.5, -3.0, 0.0]
    path = native.kino_astar_plan(hill, fe, start, goal)
    assert path is not None and len(path) >= 3
    np.testing.assert_allclose(path[0], start, atol=1e-9)
    np.testing.assert_allclose(path[-1], goal, atol=1e-9)
    occ = hill.occ_xy.numpy()
    for p in path:
        ix = int((p[0] - hill.origin[0]) / hill.xy_resolution)
        iy = int((p[1] - hill.origin[1]) / hill.xy_resolution)
        assert not occ[ix, iy]
    steps = np.linalg.norm(np.diff(path[:, :2], axis=0), axis=1)
    assert steps.max() < fe.max_vel * fe.time_interval + 1e-6


def test_port_search_succeeds_where_the_oracle_finds_a_path(hill):
    """4 scenarios of `bench.scene_eval`'s sampler on the full hill: every
    one the C++ A* finds feasible, the port's batched search solves too
    (the wider agreement runs on the card, chip_smoke.py `oracle`)."""
    from uneven_planner_tpu_torch.bench import scene_eval
    cfg = scene_config("hill")
    starts, goals = scene_eval.sample_free_scenarios(
        hill.occ_xy.numpy(), cfg.map, 4, np.random.default_rng(0))
    feasible = np.array([native.kino_astar_plan(hill, cfg.frontend, s, g)
                         is not None for s, g in zip(starts, goals)])
    assert feasible.any()
    kres = kino_init.plan(hill, cfg.frontend, t64(starts), t64(goals))
    assert kres.success.numpy()[feasible].all(), (feasible, kres.success)


def test_map_csv_matches_the_port_io(tmp_path):
    """tests/test_native.py:31 with the port's readers and writers: the
    C++ CSV round trip is exact, and each side reads what the other
    wrote (the port's writer prints shortest round-trip reprs)."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(6, 5, 4, 4))
    p_cpp, p_py = str(tmp_path / "cpp.map"), str(tmp_path / "py.map")
    native.map_csv_write(p_cpp, torch.as_tensor(data))
    np.testing.assert_array_equal(native.map_csv_read(p_cpp, (6, 5, 4)),
                                  data)
    np.testing.assert_allclose(io.load_map_csv(p_cpp, (6, 5, 4)), data,
                               rtol=1e-12)
    io.save_map_csv(p_py, data)
    np.testing.assert_allclose(native.map_csv_read(p_py, (6, 5, 4)), data,
                               rtol=1e-12)


def test_pcd_load_matches_the_port_reader(tmp_path):
    """The C++ PCD reader (crop + 1 cm centroid voxel filter) and the
    port's `io.load_scene_cloud` give the same cloud of a written PCD, up
    to the order of the voxels."""
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-2, 2, (3000, 2)),
                          rng.uniform(-0.5, 1.0, (3000, 1))], 1)
    pts[:50, 0] = 12.0                      # outside the crop box
    mesh.save_pcd(str(tmp_path / "cloud.pcd"), pts)
    got = native.pcd_load(str(tmp_path / "cloud.pcd"))
    want = io.load_scene_cloud("cloud", str(tmp_path))
    assert got.shape == want.shape
    key = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_allclose(key(got), key(want), atol=1e-6)


def _dump():
    with open(os.path.join(REPO, "QP_DUMP_r05.json")) as f:
        d = json.load(f)
    return d, [np.asarray(d[k], np.float64) for k in "PqAlu"]


def _box_qp(seed, n=12, m=20):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    A = np.concatenate([np.eye(n), rng.normal(size=(m - n, n))])
    l = -rng.uniform(0.1, 1.0, m)
    u = rng.uniform(0.1, 1.0, m)
    l[n] = u[n] = 0.3                       # one equality row
    return P, rng.normal(size=n) * 3.0, A, l, u


@pytest.mark.parametrize("case", ["dump"] + [f"box{s}" for s in range(8)])
def test_qp_ref_matches_the_jax_copy(case):
    """The port's certified float64 active-set oracle against the JAX
    package's: z within 1e-10 and both certified (KKT residuals <= 1e-9
    of the larger of 1 and max |q|); on the dump also the recorded
    optimum within 1e-10."""
    if case == "dump":
        d, qp = _dump()
    else:
        qp = _box_qp(int(case[3:]))
    z, y = qp_ref.solve_qp_f64(*qp)
    jz, jy = jqp_ref.solve_qp_f64(*qp)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-10)
    scale = max(1.0, float(np.abs(qp[1]).max()))
    for zz, yy, res in ((z, y, qp_ref.kkt_residuals_f64),
                        (jz, jy, jqp_ref.kkt_residuals_f64)):
        assert max(res(*qp, zz, yy)) <= 1e-9 * scale
    if case == "dump":
        np.testing.assert_allclose(z, d["x_activeset_f64"], rtol=0,
                                   atol=1e-10)


def test_qp_ref_raises_when_it_cannot_certify():
    """An infeasible box (l > u on a row) leaves the KKT residuals large:
    QPRefError, never a silent answer."""
    P, q, A, l, u = _box_qp(0)
    l[0], u[0] = 1.0, -1.0
    with pytest.raises(qp_ref.QPRefError):
        qp_ref.solve_qp_f64(P, q, A, l, u, max_iter=20)


def test_admm_twin_on_the_dump_within_the_baseline_gate():
    """The port's ADMM (its plain twin on the CPU) with the controller's
    settings on the dumped QP and 7 copies with each entry of q scaled by
    1 + 1e-2 noise (a tick's QP with other weights, zero entries kept):
    every lane within 1e-3 of the port's certified f64 optimum (BASELINE's
    control-sequence gate)."""
    _, (P, q, A, l, u) = _dump()
    rng = np.random.default_rng(0)
    qs = np.stack([q] + [q * (1.0 + rng.normal(size=q.shape) * 1e-2)
                         for _ in range(7)])
    want = np.stack([qp_ref.solve_qp_f64(P, qq, A, l, u)[0] for qq in qs])
    B = len(qs)
    rep = lambda a: t64(np.broadcast_to(a, (B,) + a.shape).copy())
    cfg = MPCConfig()
    sol = admm_qp.solve_qp(
        rep(P), t64(qs), rep(A), rep(l), rep(u), rho=cfg.qp_rho,
        sigma=cfg.qp_sigma, alpha=cfg.qp_alpha, eps_abs=cfg.qp_abs_tol,
        eps_rel=cfg.qp_rel_tol, max_iter=cfg.qp_max_iter,
        polish=cfg.qp_polish, adaptive_rho=cfg.qp_adaptive_rho,
        fixed_iters=cfg.qp_scan_iters)
    gap = np.abs(sol.x.numpy() - want).max(1)
    assert (gap <= 1e-3).all(), gap
