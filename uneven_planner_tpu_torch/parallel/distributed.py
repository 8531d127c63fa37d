"""Multi-process scenario batching over `torch.distributed` (port of
`uneven_planner_tpu/parallel/distributed.py`).

Every process runs the same program: `initialize` joins the process group,
each process generates and solves only its own contiguous shard of the
global scenario batch on its local devices (`parallel/mesh.py`), and the
only traffic between processes is the sum of two counts (converged lanes,
inner iterations).  The backend is NCCL when the process's devices are
CUDA devices and gloo on the CPU.  NCCL takes one rank a card.

Entry points:
- `initialize(...)`: joins the group from arguments or the
  UNEVEN_COORDINATOR / UNEVEN_NUM_PROCESSES / UNEVEN_PROCESS_ID
  environment variables; a no-op without them.  `shutdown()` leaves it.
- `hierarchical_mesh()`: the (processes x local devices) layout.
- `batch_sharding` / `shard_scenarios(...)`: where this process's lanes sit
  in the global batch.
- `plan_batch_global(...)`: the local solve, then the counts summed over
  the process group.
- `launch_local(...)`: forks N processes on this machine (gloo on the CPU,
  or NCCL with a card a process) to run the whole multi-process path
  without a cluster.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.parallel import mesh as pmesh
from uneven_planner_tpu_torch.solver import alm

# this process's devices, comma-separated (e.g. "cpu,cpu,cpu,cpu" or
# "cuda:0"), for `local_devices`
LOCAL_DEVICES_ENV = "UNEVEN_LOCAL_DEVICES"


def _world() -> tuple:
    """(process count, this process's rank): (1, 0) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_devices(devices: Optional[Sequence] = None) -> list:
    """This process's devices: `devices`, else UNEVEN_LOCAL_DEVICES, else
    CUDA: every card when the process is alone, the card `rank % count`
    when it is one of several (one rank a card, as NCCL requires).
    Raises without CUDA when nothing names the CPU."""
    if devices is None and os.environ.get(LOCAL_DEVICES_ENV):
        devices = os.environ[LOCAL_DEVICES_ENV].split(",")
    if devices is not None:
        return pmesh.make_mesh(devices)
    return _cards(*_world())


def _cards(n: int, rank: int) -> list:
    cards = pmesh.make_mesh(None)
    return cards if n == 1 else [cards[rank % len(cards)]]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 300.0) -> bool:
    """Join (or form) the process group; True when this process is in one.

    Arguments default to the UNEVEN_COORDINATOR (host:port) /
    UNEVEN_NUM_PROCESSES / UNEVEN_PROCESS_ID environment variables, so the
    same program text runs in every process.  A no-op, returning False,
    when neither arguments nor variables name a coordinator.  NCCL when
    this process's devices (`local_devices`) are CUDA devices, gloo
    otherwise."""
    addr = coordinator_address or os.environ.get("UNEVEN_COORDINATOR")
    if addr is None:
        return False
    n = num_processes if num_processes is not None else int(
        os.environ["UNEVEN_NUM_PROCESSES"])
    rank = process_id if process_id is not None else int(
        os.environ["UNEVEN_PROCESS_ID"])
    if dist.is_initialized():
        raise RuntimeError("this process is in a process group already")
    named = os.environ.get(LOCAL_DEVICES_ENV)
    devices = (pmesh.make_mesh(named.split(",")) if named
               else _cards(n, rank))
    cuda = devices[0].type == "cuda"
    if cuda:
        torch.cuda.set_device(devices[0])
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class HierarchicalMesh(NamedTuple):
    """The (processes x local devices) layout: this process's rank, the
    process count and its local devices.  Every process holds as many
    devices as the others."""
    num_processes: int
    process_index: int
    local: list

    @property
    def shape(self) -> tuple:
        return (self.num_processes, len(self.local))


def hierarchical_mesh(devices: Optional[Sequence] = None) -> HierarchicalMesh:
    """The [processes, devices a process] mesh: the process group's size
    and rank (1 and 0 outside one) and this process's devices
    (`local_devices`).  A batch sharded over it keeps each scenario on one
    device and each process's shard on its own devices."""
    n, rank = _world()
    local = local_devices(devices)
    if n > 1:
        counts = [None] * n
        dist.all_gather_object(counts, len(local))
        if len(set(counts)) != 1:
            raise ValueError(f"uneven devices per process: {counts}")
    return HierarchicalMesh(n, rank, local)


class BatchSharding(NamedTuple):
    """Where one process's lanes sit in the global batch."""
    mesh: HierarchicalMesh

    def local_batch(self, global_batch: int) -> int:
        n = self.mesh.num_processes * len(self.mesh.local)
        if global_batch % n:
            raise ValueError(f"a batch of {global_batch} lanes does not "
                             f"divide over {self.mesh.shape} devices")
        return global_batch // self.mesh.num_processes

    def offset(self, global_batch: int) -> int:
        return self.mesh.process_index * self.local_batch(global_batch)


def batch_sharding(mesh: HierarchicalMesh) -> BatchSharding:
    """The scenario batch over both mesh axes: process p holds the p-th
    contiguous block, cut again over its devices."""
    return BatchSharding(mesh)


class ShardedScenarios(NamedTuple):
    """This process's shard of the global batch: x0s [B_local, n] and the
    Boundary of [B_local, ...], on its first device, with the shard's
    offset in the global batch and the global batch size."""
    x0s: torch.Tensor
    bounds: alm.Boundary
    offset: int
    global_batch: int


def shard_scenarios(mesh: HierarchicalMesh, local_x0s,
                    local_bounds) -> ShardedScenarios:
    """This process's scenarios (numpy or tensors, B_local lanes each, as
    every process generates only its own) as its shard of a global batch
    of B_local x processes lanes."""
    dev = mesh.local[0]
    to = lambda a: torch.as_tensor(a).to(dev)
    x0s = to(local_x0s)
    B = x0s.shape[0] * mesh.num_processes
    sharding = batch_sharding(mesh)
    return ShardedScenarios(x0s, alm.tree_map(to, local_bounds),
                            sharding.offset(B), B)


def plan_batch_global(mesh: HierarchicalMesh, shape: alm.ProblemShape, grid,
                      cfg, lbfgs_overrides: Optional[dict] = None):
    """run(scenarios: ShardedScenarios) -> (this process's ALMResult,
    (n_converged, n_inner)): the flat solve of the local shard over the
    local devices (`mesh.plan_batch_shard_map`), then the two counts summed
    over the process group (the only traffic between processes).  The
    counts are int64 0-dim tensors on the first local device."""
    local = pmesh.plan_batch_shard_map(mesh.local, shape, grid, cfg,
                                       lbfgs_overrides)

    def run(scen: ShardedScenarios):
        res, (n_conv, n_inner) = local(scen.x0s, scen.bounds)
        counts = torch.stack([n_conv, n_inner]).to(torch.int64)
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(counts)
        return res, (counts[0], counts[1])
    return run


# ---------------------------------------------------------------------------
# Local multi-process launcher (tests and one-machine scaling runs)
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_WORKER_PROLOGUE = """
import os, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from uneven_planner_tpu_torch.parallel import distributed
distributed.initialize({coord!r}, {nprocs}, {pid}, timeout_s={timeout!r})
pid = {pid}
nprocs = {nprocs}
"""

_WORKER_EPILOGUE = """
distributed.shutdown()
"""


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(worker_body: str, num_processes: int = 2,
                 local_devices: int = 4, timeout: float = 600.0,
                 port: Optional[int] = None, device: Optional[str] = None):
    """Fork `num_processes` processes on this machine, each running
    `worker_body` (Python source, run after `initialize` with `pid` and
    `nprocs` in scope, then `shutdown`), and return [(returncode, output)]
    a process.  Each process imports torch and this package only, runs
    PyTorch on one thread (OMP_NUM_THREADS=1, `torch.set_num_threads(1)`)
    and holds `local_devices` CPU shards (`device="cpu"`, gloo) or card
    `pid` (`device=None` or `"cuda"`, NCCL, one rank a card; raises
    without CUDA).  A process still running after `timeout` seconds is
    killed and counts as failed."""
    port = port or free_port()
    if device == "cpu":
        locals_ = lambda pid: ",".join(["cpu"] * local_devices)
    elif device is None or device == "cuda":
        resolve_device(None)
        if num_processes > torch.cuda.device_count():
            raise ValueError(f"{num_processes} NCCL ranks need as many "
                             f"cards, this machine has "
                             f"{torch.cuda.device_count()}")
        locals_ = lambda pid: f"cuda:{pid}"
    else:
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    procs = []
    for pid in range(num_processes):
        src = (_WORKER_PROLOGUE.format(
            root=_ROOT, coord=f"127.0.0.1:{port}", nprocs=num_processes,
            pid=pid, timeout=float(timeout))
            + worker_body + _WORKER_EPILOGUE)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   **{LOCAL_DEVICES_ENV: locals_(pid)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=_ROOT))
    out = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            stdout, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        out.append((p.returncode, stdout))
    return out
