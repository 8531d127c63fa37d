"""The port's compacted solve against its own uncompacted solve: bucketed
compaction, sliced dispatch (`max_dispatch`) and the narrow retry
(`retry_width`) change no lane."""

import dataclasses

import pytest
import torch

from uneven_planner_tpu_torch import convert, headline
from uneven_planner_tpu_torch.config import scene_config
from uneven_planner_tpu_torch.solver import alm as talm

from torch_parity import (CPU, assert_lanes_match, jax_grid, lane_stability,
                          port_grid, scenarios)

HC = headline.HeadlineConfig(piece_xy=6, piece_yaw=12, int_K=8)


@pytest.fixture(scope="module")
def grid():
    return port_grid(jax_grid())


def test_compaction_dispatch_and_retry_change_no_lane(grid):
    """Lane by lane against the uncompacted solve.  Widths 16/8/4 give the
    same lanes bit for bit here; other widths (slices of 5) make the CPU
    GEMM round differently, which only a lane whose counts already move
    under a tiny input change can feel."""
    x0, bnd = scenarios(16, 11, 6, 12)
    B = convert.boundary_from_numpy(bnd, device=CPU)
    # max_iter 8 leaves one lane unconverged, so the retry pass runs
    cfg = dataclasses.replace(scene_config("hill").alm, max_iter=8)
    base, stable, spread = lane_stability(
        lambda x: talm.solve_flat(x, B, HC.shape, grid, cfg,
                                  lbfgs_overrides=HC.overrides),
        x0, eps=(1e-15, -1e-15, 1e-14, -1e-14), wrap=torch.tensor)
    assert 1 <= int((~base.converged).sum()) <= 4
    X = torch.tensor(x0)
    kw = dict(lbfgs_overrides=HC.overrides, chunk_steps=16,
              buckets=(1, 2, 4))
    compact = talm.solve_flat_compacted(X, B, HC.shape, grid, cfg,
                                        max_dispatch=16, retry_width=None,
                                        **kw)
    sliced = talm.solve_flat_compacted(X, B, HC.shape, grid, cfg,
                                       max_dispatch=5, retry_width=None,
                                       **kw)
    retried = talm.solve_flat_compacted(X, B, HC.shape, grid, cfg,
                                        max_dispatch=16, retry_width=8, **kw)
    assert retried.steps > compact.steps      # the retry pass ran
    for name in ("x", "evals", "converged", "res_h", "res_g"):
        assert torch.equal(getattr(compact, name), getattr(base, name))
        assert torch.equal(getattr(retried, name), getattr(base, name))
    assert_lanes_match(base, sliced, stable, spread, min_stable=12)
