"""Port parity: scenario batching over a mesh of devices and over
`torch.distributed` processes (`parallel/mesh.py`, `parallel/distributed.py`)
against the JAX package's `parallel/mesh.py` and tests/test_parallel.py, on
the CPU (a mesh of CPU shards for the 8 virtual CPU devices, gloo between
processes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu.config import ALMConfig as JALMConfig
from uneven_planner_tpu.parallel import mesh as jmesh
from uneven_planner_tpu.solver import alm as jalm
from uneven_planner_tpu_torch import convert, manager
from uneven_planner_tpu_torch.config import ALMConfig, ManagerConfig, MapConfig
from uneven_planner_tpu_torch.parallel import distributed as dist
from uneven_planner_tpu_torch.parallel import mesh as pmesh
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

from torch_parity import (CPU, EPS, assert_lanes_match, jax_grid,
                          lane_stability, port_grid, scenarios, to_jax)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """Thousands of small tensor operations: one thread (the suite's
    workers would oversubscribe the cores), then the setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_problem(dtype=np.float64):
    """tests/test_parallel.py's problem: the 0.25 m hill grid, one straight
    path, ProblemShape(4, 8, 8)."""
    grid = make_synthetic_grid(MapConfig(xy_resolution=0.25,
                                         yaw_resolution=0.45), dtype=dtype,
                               device="cpu")
    t = np.linspace(0, 1, 12)[:, None]
    path = np.concatenate(
        [(1 - t) * np.array([-3.0, -3.0]) + t * np.array([-1.5, -3.0]),
         np.zeros((12, 1))], axis=1)
    x0, bound = manager.init_guess_fixed(path, ManagerConfig(), piece_xy=4,
                                         piece_yaw=8)
    shape = alm.ProblemShape(piece_xy=4, piece_yaw=8, int_K=8)
    return grid, x0, bound, shape


def _lanes(x0, bound, B, dtype=torch.float64):
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    x0s = to(x0).expand(B, -1).contiguous()
    bounds = alm.tree_map(lambda a: to(a).expand((B,) + a.shape)
                          .contiguous(), bound)
    return x0s, bounds


def test_shard_map_batch_over_8_shards():
    """tests/test_parallel.py:26 on the port: 16 identical lanes over 8 CPU
    shards give identical outputs on every shard, and the summed inner
    iterations are the lanes' sum."""
    grid, x0, bound, shape = _tiny_problem()
    mesh = pmesh.make_mesh(["cpu"] * 8)
    run = pmesh.plan_batch_shard_map(
        mesh, shape, grid, ALMConfig(),
        lbfgs_overrides={"mem_size": 4, "max_iterations": 5})
    res, (n_conv, n_inner) = run(*_lanes(x0, bound, 16))
    assert res.x.shape[0] == 16
    x = res.x.numpy()
    np.testing.assert_allclose(x, np.broadcast_to(x[0], x.shape), atol=1e-12)
    assert int(n_inner) == int(res.inner_iters.sum())
    assert int(n_conv) == int(res.converged.sum())


def test_plan_batch_keeps_lane_order_and_refuses_uneven_batches():
    """Each shard's lanes come back where they were: 4 different lanes over
    2 shards equal each shard solved alone; a batch that does not divide
    over the mesh raises."""
    grid, x0, bound, shape = _tiny_problem()
    x0s, bounds = _lanes(x0, bound, 4)
    x0s = x0s * torch.tensor([1.0, 1.01, 0.99, 1.02])[:, None]
    ovr = {"mem_size": 4, "max_iterations": 5}
    res = pmesh.plan_batch(pmesh.make_mesh(["cpu", "cpu"]), shape, grid,
                           ALMConfig(), ovr)(x0s, bounds)
    for sl in (slice(0, 2), slice(2, 4)):
        alone = alm.solve_flat(x0s[sl], alm.tree_map(lambda a: a[sl], bounds),
                               shape, grid, ALMConfig(), lbfgs_overrides=ovr)
        assert torch.equal(res.x[sl], alone.x)
        assert torch.equal(res.inner_iters[sl], alone.inner_iters)
    with pytest.raises(ValueError):
        pmesh.plan_batch(pmesh.make_mesh(["cpu"] * 3), shape, grid,
                         ALMConfig(), ovr)(x0s, bounds)


def test_shard_map_matches_jax_lane_by_lane():
    """The port's shard map over 8 CPU shards against the JAX package's
    `plan_batch_shard_map` over its 8 virtual CPU devices on the same 8
    lanes: per lane as tests/test_torch_alm.py holds `solve_flat` (counts
    exactly and x to JAX's own spread on stable lanes, the converged flags
    equal, every x within the ALM band), and the summed counts equal."""
    jg = jax_grid()
    tg = port_grid(jg)
    x0, bnd = scenarios(8, 9, 6, 12)
    ovr = {"mem_size": 8, "max_iterations": 40}
    jshape, tshape = jalm.ProblemShape(6, 12, 8), alm.ProblemShape(6, 12, 8)
    jrun = jmesh.plan_batch_shard_map(
        jmesh.make_mesh(jax.devices("cpu")[:8]), jshape, jg, JALMConfig(),
        lbfgs_overrides=ovr)
    ref, stable, spread = lane_stability(lambda x, b: jrun(x, b)[0], x0,
                                         to_jax(bnd), eps=EPS[:4])
    _, (j_conv, j_inner) = jrun(jnp.asarray(x0), to_jax(bnd))
    run = pmesh.plan_batch_shard_map(pmesh.make_mesh(["cpu"] * 8), tshape,
                                     tg, ALMConfig(), lbfgs_overrides=ovr)
    res, (n_conv, n_inner) = run(torch.tensor(x0),
                                 convert.boundary_from_numpy(bnd, device=CPU))
    assert_lanes_match(ref, res, stable, spread, min_stable=6)
    assert int(n_conv) == int(j_conv)
    if stable.all():
        assert int(n_inner) == int(j_inner)


def test_single_process_layout_and_no_op_initialize(monkeypatch):
    """Without a coordinator `initialize` is a no-op; alone, the mesh is
    one process of the named local devices, its shard starts at 0 and
    `plan_batch_global` sums nothing across processes."""
    for k in ("UNEVEN_COORDINATOR", "UNEVEN_NUM_PROCESSES",
              "UNEVEN_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.initialize() is False
    monkeypatch.setenv(dist.LOCAL_DEVICES_ENV, "cpu,cpu")
    mesh = dist.hierarchical_mesh()
    assert mesh.shape == (1, 2) and mesh.process_index == 0
    grid, x0, bound, shape = _tiny_problem()
    x0s, bounds = _lanes(x0, bound, 4)
    scen = dist.shard_scenarios(mesh, x0s.numpy(),
                                alm.tree_map(lambda a: a.numpy(), bounds))
    assert scen.offset == 0 and scen.global_batch == 4
    assert dist.batch_sharding(mesh).local_batch(8) == 8
    with pytest.raises(ValueError):
        dist.batch_sharding(mesh).local_batch(3)
    ovr = {"mem_size": 4, "max_iterations": 5}
    res, (n_conv, n_inner) = dist.plan_batch_global(
        mesh, shape, grid, ALMConfig(), ovr)(scen)
    assert int(n_inner) == int(res.inner_iters.sum())
    assert int(n_conv) == int(res.converged.sum())


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError):
        dist.launch_local("", num_processes=1, device="cuda")


_MP_WORKER = """
import numpy as np
import torch
from uneven_planner_tpu_torch import manager
from uneven_planner_tpu_torch.config import ALMConfig, ManagerConfig, MapConfig
from uneven_planner_tpu_torch.parallel import distributed as dist
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

assert torch.distributed.get_world_size() == nprocs
grid = make_synthetic_grid(MapConfig(xy_resolution=0.25, yaw_resolution=0.45),
                           dtype=np.float32, device="cpu")
shape = alm.ProblemShape(piece_xy=4, piece_yaw=8, int_K=8)
t = np.linspace(0, 1, 12)[:, None]
path = np.concatenate(
    [(1 - t) * np.array([-3.0, -3.0]) + t * np.array([-1.5, -3.0]),
     np.zeros((12, 1))], axis=1)
x0, bound = manager.init_guess_fixed(path, ManagerConfig(), piece_xy=4,
                                     piece_yaw=8)
B_local = 4   # one scenario a local shard
x0s = np.broadcast_to(np.asarray(x0, np.float32),
                      (B_local,) + x0.shape).copy()
bounds = alm.tree_map(lambda a: np.broadcast_to(
    np.asarray(a, np.float32), (B_local,) + a.shape).copy(), bound)

mesh = dist.hierarchical_mesh()
assert mesh.shape == (nprocs, 4), mesh.shape
scen = dist.shard_scenarios(mesh, x0s, bounds)
assert scen.global_batch == nprocs * B_local
assert scen.offset == pid * B_local
ov = {"mem_size": 8, "max_iterations": 30}
res, (n_conv, n_inner) = dist.plan_batch_global(mesh, shape, grid, ALMConfig(),
                                                lbfgs_overrides=ov)(scen)
ref = alm.solve_flat(torch.as_tensor(x0s),
                     alm.tree_map(torch.as_tensor, bounds), shape, grid,
                     ALMConfig(), lbfgs_overrides=ov)
ok = np.allclose(res.x.numpy(), ref.x.numpy(), atol=1e-2)
local_conv = int(ref.converged.sum())
print("RESULT", pid, int(n_conv), local_conv * nprocs, bool(ok), flush=True)
assert int(n_conv) == local_conv * nprocs
assert int(n_inner) >= int(res.inner_iters.sum())
assert ok
print("WORKER_OK", pid, flush=True)
"""


def test_multiprocess_two_hosts():
    """tests/test_parallel.py:110 on the port: 2 gloo processes x 4 local
    CPU shards form one (2, 4) mesh; the converged count summed across the
    processes is 2 x the local unsharded run's, and x is within the JAX
    test's 1e-2 of it.  The launch has its own 300 s limit."""
    out = dist.launch_local(_MP_WORKER, num_processes=2, local_devices=4,
                            timeout=300.0, device="cpu")
    for rc, stdout in out:
        assert rc == 0, stdout[-2000:]
        assert "WORKER_OK" in stdout, stdout[-2000:]
