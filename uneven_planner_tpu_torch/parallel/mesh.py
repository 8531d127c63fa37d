"""Scenario parallelism over a list of devices (port of
`uneven_planner_tpu/parallel/mesh.py`).

The parallel axis is the scenario batch: a whole flat ALM solve is the unit
of work, and a batch of B lanes is cut into contiguous shards, one a
device.  Inside a shard everything stays on its device; across the mesh
only the converged count and the total inner iterations are summed.

A mesh is a list of `torch.device`s (the same device may appear several
times: a mesh of 8 CPU shards stands for the JAX tests' 8 virtual CPU
devices).  One process runs its shards one after another; one process per
card (`parallel/distributed.py`) runs them side by side.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from uneven_planner_tpu_torch import resolve_device
from uneven_planner_tpu_torch.solver import alm


def make_mesh(devices: Optional[Sequence] = None) -> list:
    """The devices of a 1-D mesh: `devices` as `torch.device`s, or every
    CUDA device when None (raises without CUDA, as `resolve_device`)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def _shards(B: int, n: int):
    if B % n:
        raise ValueError(f"a batch of {B} lanes does not divide over {n} "
                         "devices")
    size = B // n
    return [slice(k * size, (k + 1) * size) for k in range(n)]


def _solve_shards(mesh: list, shape: alm.ProblemShape, grid, cfg,
                  lbfgs_overrides, x0s, bounds):
    """The flat solve of each contiguous shard of (x0s, bounds) on its
    device, with a copy of the grid there: the shards' results."""
    grids = {}
    parts = []
    for dev, sl in zip(mesh, _shards(x0s.shape[0], len(mesh))):
        if dev not in grids:
            grids[dev] = grid if grid.device == dev else grid.to(dev)
        on = lambda a: a[sl].to(dev)
        parts.append(alm.solve_flat(
            on(x0s), alm.tree_map(on, bounds), shape, grids[dev], cfg,
            lbfgs_overrides=lbfgs_overrides))
    return parts


def _gather(mesh: list, parts) -> alm.ALMResult:
    """The shards' results in lane order, on the mesh's first device."""
    home = mesh[0]
    return alm._cat_results([
        alm.ALMResult(*[None if f is None else alm.tree_map(
            lambda a: a.to(home), f) for f in r[:alm._LANE_FIELDS]],
            steps=r.steps, polls=r.polls) for r in parts])


def plan_batch(mesh: list, shape: alm.ProblemShape, grid, cfg,
               lbfgs_overrides: Optional[dict] = None):
    """(x0s [B, n], bounds Boundary of [B, ...]) -> ALMResult: the flat
    solve with the batch cut over the mesh, B divisible by the mesh size,
    each device solving its contiguous shard on its own copy of the grid;
    the lanes come back in order on the mesh's first device.  `steps` and
    `polls` are the shards' sums."""
    def run(x0s, bounds):
        return _gather(mesh, _solve_shards(mesh, shape, grid, cfg,
                                           lbfgs_overrides, x0s, bounds))
    return run


def _counts(parts):
    """(converged lanes, inner iterations) summed over the shards, as int64
    0-dim tensors on the first shard's device."""
    home = parts[0].x.device
    n_conv = sum(r.converged.sum().to(home) for r in parts)
    n_inner = sum(r.inner_iters.to(torch.int64).sum().to(home)
                  for r in parts)
    return n_conv, n_inner


def plan_batch_shard_map(mesh: list, shape: alm.ProblemShape, grid, cfg,
                         lbfgs_overrides: Optional[dict] = None):
    """`plan_batch` returning (result, (n_converged, n_inner)): the
    converged count and the total inner iterations summed over the
    shards (the JAX package's psum over the mesh axis)."""
    def run(x0s, bounds):
        parts = _solve_shards(mesh, shape, grid, cfg, lbfgs_overrides, x0s,
                              bounds)
        return _gather(mesh, parts), _counts(parts)
    return run
