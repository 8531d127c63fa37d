"""The port's CUDA kernels against their plain PyTorch twins on the same
CUDA tensors (fp32).  Needs a card: every test here is marked `cuda` and
skips without one.  Imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

MODES = ["pair", "packed16", "packed16_exact"]


@pytest.fixture(scope="module")
def cuda_grid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = make_synthetic_grid(MapConfig(xy_resolution=0.2, yaw_resolution=0.45),
                            dtype=np.float32, device="cuda")
    return tgrid.with_packed_f16(tgrid.with_pair_table(g))


def _poses(M, seed, device):
    """Interior, edge, yaw-wrap and out-of-map samples."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-5.3, 5.3, M)
    py = rng.uniform(-5.3, 5.3, M)
    yaw = rng.uniform(-np.pi, np.pi, M)
    py[:64] = -5.0 + rng.uniform(0.0, 0.1, 64)      # iyf < 0 strip
    yaw[64:128] = -np.pi
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (px, py, yaw)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("want_jac", [False, True])
def test_kernel_matches_twin_on_card(cuda_grid, mode, want_jac):
    g = cuda_grid
    px, py, yaw = _poses(8192, 5, g.device)
    geom = tgrid.kernel_geometry(g)
    before = dict(kernels.launches)
    if mode == "pair":
        want = tgrid.pair_tv_jac(g, px, py, yaw, want_jac)
        got = kernels.terrain_tv_pair(g.data_pair, geom, px, py, yaw,
                                      want_jac)
        name = "terrain_tv_pair"
    else:
        exact = mode == "packed16_exact"
        want = tgrid.packed16_tv_jac(g, px, py, yaw, exact, want_jac)
        got = kernels.terrain_tv_packed16(g.data_packed16, geom, px, py, yaw,
                                          exact, want_jac)
        name = "terrain_tv_packed16"
    torch.cuda.synchronize()
    assert kernels.launches[name] == before[name] + 1
    # fp32: both sides round each operation; differences come from the
    # transcendental functions' last bits (tv ~1, J ~1e2)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    if want_jac:
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_autograd_on_card_goes_through_kernel(cuda_grid):
    """Reverse and forward mode on CUDA tensors launch the kernel (once per
    forward) and agree with the twin's J."""
    g = cuda_grid
    px, py, yaw = _poses(4096, 6, g.device)
    ins = [t.clone().requires_grad_(True) for t in (px, py, yaw)]
    before = kernels.launches["terrain_tv_packed16"]
    tv = tgrid.get_terrain_variables_cm(g, *ins, exact=False)
    grads = torch.autograd.grad(tv.sum(), ins)
    assert kernels.launches["terrain_tv_packed16"] == before + 1
    _, jac = tgrid.packed16_tv_jac(g, px, py, yaw, False, True)
    for k in range(3):
        torch.testing.assert_close(grads[k], jac[:, k].sum(0), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.cuda
def test_launcher_rejects_float64_on_card(cuda_grid):
    g = cuda_grid
    x = torch.zeros(16, dtype=torch.float64, device=g.device)
    with pytest.raises(TypeError):
        kernels.terrain_tv_pair(g.data_pair, tgrid.kernel_geometry(g), x, x,
                                x, False)
