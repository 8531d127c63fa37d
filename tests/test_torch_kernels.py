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


# ---------------------------------------------------------------------------
# K3 gather_rows and K4 gather_along (csrc/gather.cu)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _indices(rng, n, shape):
    """Random indices with out-of-range and negative ones mixed in."""
    idx = rng.integers(0, n, shape)
    flat = idx.reshape(-1)
    flat[::7] = rng.integers(n, 3 * n, len(flat[::7]))
    flat[3::11] = -rng.integers(1, 2 * n, len(flat[3::11]))
    flat[:4] = [0, n - 1, n, -1]
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8,
                                   torch.bool])
@pytest.mark.parametrize("width", [None, 1, 3, 4, 8, 12, 128])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_kernel_matches_twin_on_card(card, dtype, width,
                                                 idx_dtype):
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(0)
    n, m = 1000, 20001
    shape = (n,) if width is None else (n, width)
    table = torch.tensor(rng.integers(0, 2 if dtype == torch.bool else 200,
                                      shape)).to(dtype).to(card)
    idx = torch.tensor(_indices(rng, n, m)).to(idx_dtype).to(card)
    before = gather.launches["gather_rows"]
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.launches["gather_rows"] == before + 1
    assert torch.equal(got, gather.gather_rows_twin(table, idx))
    # the twin on the CPU says the same
    assert torch.equal(got.cpu(), gather.gather_rows(table.cpu(), idx.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_along_kernel_matches_twin_on_card(card, dtype, axis,
                                                  idx_dtype):
    from uneven_planner_tpu_torch.kernels import gather
    rng = np.random.default_rng(1)
    for xs, ishape in (((256, 128), (256, 128)),
                       ((37, 1000), (37, 61) if axis == 1 else (90, 1000))):
        x = torch.tensor(rng.integers(-500, 500, xs)).to(dtype).to(card)
        idx = torch.tensor(_indices(rng, xs[axis], ishape)).to(idx_dtype) \
            .to(card)
        before = gather.launches["gather_along"]
        got = gather.gather_along(x, idx, axis)
        torch.cuda.synchronize()
        assert gather.launches["gather_along"] == before + 1
        assert torch.equal(got, gather.gather_along_twin(x, idx, axis))


@pytest.mark.cuda
def test_gather_kernels_reject_what_they_do_not_take_on_card(card):
    from uneven_planner_tpu_torch.kernels import gather
    x64 = torch.zeros((8, 8), dtype=torch.float64, device=card)
    idx = torch.zeros((8, 2), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        gather.gather_along(x64, idx)
    with pytest.raises(TypeError):
        gather.gather_rows(x64, idx[:, 0].contiguous())
    x = torch.zeros((8, 8), device=card)
    with pytest.raises(ValueError):
        gather.gather_along(x.t(), idx)                 # not contiguous
    with pytest.raises(ValueError):
        gather.gather_along(x, idx.cpu())               # devices differ


@pytest.mark.cuda
def test_search_on_card_launches_the_gather_kernels(cuda_grid):
    """A small search on the card goes through K1, K3 and K4 and returns
    valid paths."""
    from uneven_planner_tpu_torch.config import FrontendConfig
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.kernels import gather
    import dataclasses
    fe = dataclasses.replace(FrontendConfig(), frontier_size=128,
                             max_rounds=60)
    start = torch.tensor([[-3.0, -3.0, 0.0], [-2.0, -3.0, 1.0]],
                         device=cuda_grid.device)
    goal = torch.tensor([[0.5, -3.0, 0.0], [-2.0, -0.5, 1.5]],
                        device=cuda_grid.device)
    before = dict(gather.launches), kernels.launches["terrain_tv_packed16"]
    res = kino_init.plan(cuda_grid, fe, start, goal)
    assert res.success.all()
    assert gather.launches["gather_rows"] > before[0]["gather_rows"]
    assert gather.launches["gather_along"] > before[0]["gather_along"]
    assert kernels.launches["terrain_tv_packed16"] > before[1]
    for lane in range(2):
        p = kino_init.extract_path(res, lane)
        np.testing.assert_allclose(p[-1], goal[lane].cpu().numpy(),
                                   atol=1e-4)
