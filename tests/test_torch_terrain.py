"""Port parity: terrain tables, lookups and their derivatives against the
JAX package (f64, coarse hill grid).  The CUDA kernels are held against
their plain twins in tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

from uneven_planner_tpu.terrain import grid as jgrid
from uneven_planner_tpu.terrain.synthetic import \
    make_synthetic_grid as jax_hill_grid
from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
from uneven_planner_tpu_torch.terrain import grid as tgrid
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

from torch_parity import TEST_CFG, jax_grid, port_grid

MODES = ["pair", "packed16", "packed16_exact"]


@pytest.fixture(scope="module")
def grids():
    jg = jax_grid()
    return jg, port_grid(jg)


def _poses(jg, M=600, seed=0):
    """Interior points plus map edges, the iyf < 0 strip, the yaw +-pi wrap
    and out-of-map points (the cases of tests/test_terrain.py)."""
    rng = np.random.default_rng(seed)
    ox, oy, _ = jg.origin
    hi_x = ox + jg.voxel_num[0] * jg.xy_resolution
    px = rng.uniform(-4.9, 4.9, M)
    py = rng.uniform(-4.9, 4.9, M)
    yaw = rng.uniform(-np.pi, np.pi, M)
    px[:20] = ox + rng.uniform(0.0, 0.15, 20)             # low-x edge
    px[20:40] = hi_x - rng.uniform(0.0, 0.15, 20)         # high-x edge
    py[40:60] = oy + rng.uniform(0.0, 0.1, 20)            # iyf < 0 strip
    py[60:80] = -oy - rng.uniform(0.0, 0.15, 20)          # high-y edge
    yaw[80:90] = np.pi - 1e-9                             # yaw wrap
    yaw[90:100] = -np.pi
    px[100:110] = rng.uniform(5.0, 7.0, 10)               # out of map
    py[110:120] = rng.uniform(-7.0, -5.0, 10)
    return px, py, yaw


def _jax_fn(jg, mode):
    if mode == "pair":
        return lambda a, b, c: jgrid.get_terrain_variables_cm(
            jg, a, b, c, exact=True)
    return lambda a, b, c: jgrid.get_terrain_variables_cm_packed16(
        jg, a, b, c, exact=mode == "packed16_exact")


def _port_fn(tg, mode):
    if mode == "pair":
        return lambda a, b, c: tgrid.get_terrain_variables_cm(
            tg, a, b, c, exact=True)
    return lambda a, b, c: tgrid.get_terrain_variables_cm_packed16(
        tg, a, b, c, exact=mode == "packed16_exact")


def _twin(tg, mode):
    if mode == "pair":
        return lambda a, b, c, j: tgrid.pair_tv_jac(tg, a, b, c, j)
    return lambda a, b, c, j: tgrid.packed16_tv_jac(
        tg, a, b, c, mode == "packed16_exact", j)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_hill_field_matches_jax(dtype):
    """The port builds its own hill field (the headline's); same bits, same
    occupancy."""
    want = jax_hill_grid(TEST_CFG, dtype=dtype)
    got = make_synthetic_grid(MapConfig(xy_resolution=0.2,
                                        yaw_resolution=0.45),
                              dtype=dtype, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    assert got.origin == tuple(want.origin)


def test_pair_table_bits_match_jax(grids):
    jg, tg = grids
    np.testing.assert_array_equal(tg.data_pair.numpy(),
                                  np.asarray(jg.data_pair).T)


def test_packed16_table_bits_match_jax(grids):
    jg, tg = grids
    words = tg.data_packed16.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        words[:, :6], np.asarray(jg.data_packed16).view(np.uint32).T)
    assert not words[:, 6:].any()


@pytest.mark.parametrize("mode", MODES)
def test_lookup_forward_matches_jax(grids, mode):
    jg, tg = grids
    px, py, yaw = _poses(jg)
    want = np.asarray(_jax_fn(jg, mode)(jnp.asarray(px), jnp.asarray(py),
                                        jnp.asarray(yaw)))
    got = _port_fn(tg, mode)(*map(torch.tensor, (px, py, yaw))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # out-of-map samples read flat ground: tv = (1, 0, 1, 0, 1, 1, 0)
    np.testing.assert_allclose(got[:, 100:120].T,
                               np.tile([1, 0, 1, 0, 1, 1, 0], (20, 1)),
                               atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_lookup_backward_and_jvp_match_jax(grids, mode):
    jg, tg = grids
    px, py, yaw = _poses(jg, seed=1)
    rng = np.random.default_rng(2)
    ct = rng.normal(size=(7, px.size))
    jf = _jax_fn(jg, mode)
    prim = tuple(jnp.asarray(a) for a in (px, py, yaw))
    _, vjp = jax.vjp(jf, *prim)
    want_vjp = [np.asarray(a) for a in vjp(jnp.asarray(ct))]

    ins = [torch.tensor(a, requires_grad=True) for a in (px, py, yaw)]
    tv = _port_fn(tg, mode)(*ins)
    got_vjp = torch.autograd.grad((tv * torch.tensor(ct)).sum(), ins)
    for w, g in zip(want_vjp, got_vjp):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10)

    tans = [rng.normal(size=px.size) for _ in range(3)]
    # all three tangents, and yaw alone (the others then have none)
    for use in ((0, 1, 2), (2,)):
        t_jax = tuple(jnp.asarray(tans[i] if i in use else np.zeros(px.size))
                      for i in range(3))
        _, want_jvp = jax.jvp(jf, prim, t_jax)
        with fwAD.dual_level():
            args = [fwAD.make_dual(torch.tensor(a), torch.tensor(tans[i]))
                    if i in use else torch.tensor(a)
                    for i, a in enumerate((px, py, yaw))]
            got_jvp = fwAD.unpack_dual(_port_fn(tg, mode)(*args)).tangent
        np.testing.assert_allclose(got_jvp.numpy(), np.asarray(want_jvp),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_twin_jacobian_is_autograd_of_twin(grids, mode):
    """The analytic J of each plain twin equals torch autograd of the twin's
    own forward, edges and out-of-map points included."""
    jg, tg = grids
    px, py, yaw = _poses(jg, M=300, seed=3)
    twin = _twin(tg, mode)
    ins = [torch.tensor(a, requires_grad=True) for a in (px, py, yaw)]
    tv, _ = twin(*ins, False)
    rows = [torch.stack(torch.autograd.grad(tv[k].sum(), ins,
                                            retain_graph=True))
            for k in range(7)]
    auto = torch.stack(rows).numpy()                       # [7, 3, M]
    _, jac = twin(*(a.detach() for a in ins), True)
    np.testing.assert_allclose(jac.numpy(), auto, rtol=1e-12, atol=1e-12)


def test_exact_false_dispatches_to_packed16(grids):
    jg, tg = grids
    px, py, yaw = map(torch.tensor, _poses(jg, M=200, seed=4))
    a = tgrid.get_terrain_variables_cm(tg, px, py, yaw, exact=False)
    b = tgrid.get_terrain_variables_cm_packed16(tg, px, py, yaw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    no16 = tg.replace(data_packed16=None)
    c = tgrid.get_terrain_variables_cm(no16, px, py, yaw, exact=False)
    d = tgrid.get_terrain_variables_cm(tg, px, py, yaw, exact=True)
    torch.testing.assert_close(c, d, rtol=0, atol=0)


def test_launchers_refuse_what_the_kernels_do_not_take(grids):
    """The CUDA launchers raise on CPU tensors and wrong dtypes before any
    build or launch; nothing falls back to the twin."""
    _, tg = grids
    geom = tgrid.kernel_geometry(tg)
    x = torch.zeros(8, dtype=torch.float32)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.terrain_tv_pair(tg.data_pair, geom, x, x, x, True)
    with pytest.raises(ValueError):
        kernels.terrain_tv_packed16(tg.data_packed16, geom, x, x, x, False,
                                    True)
    with pytest.raises(ValueError):
        tgrid.get_terrain_variables_cm(tg, x.to("meta"), x.to("meta"),
                                       x.to("meta"))
    assert kernels.launches == before


# ---------------------------------------------------------------------------
# Index maps, occupancy and the front end's sigma lookup
# ---------------------------------------------------------------------------

def _poses3(jg, M=600, seed=7):
    return np.stack(_poses(jg, M, seed), axis=1)


def test_index_maps_match_jax(grids):
    jg, tg = grids
    pos = _poses3(jg)
    want = jax.vmap(lambda p: jgrid.pos_to_index(jg, p))(jnp.asarray(pos))
    got = tgrid.pos_to_index(tg, torch.tensor(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tgrid.bound_index(tg, got).numpy(),
        np.asarray(jgrid.bound_index(jg, want)))
    np.testing.assert_allclose(
        tgrid.index_to_pos(tg, got).numpy(),
        np.asarray(jgrid.index_to_pos(jg, want)), rtol=0, atol=1e-12)
    inside = jax.vmap(lambda p: jgrid.is_in_map(jg, p))(jnp.asarray(pos))
    np.testing.assert_array_equal(
        tgrid.is_in_map(tg, torch.tensor(pos)).numpy(), np.asarray(inside))
    assert 0 < int(inside.sum()) < len(pos)


@pytest.mark.parametrize("fn", ["is_occupancy", "is_occupancy_xy",
                                "is_occupancy_xy_batch"])
def test_occupancy_matches_jax(grids, fn):
    """In-map, edge, out-of-map and yaw-wrap poses, on the hill's own
    occupancy and on a randomly occupied copy (the hill alone is almost
    free)."""
    jg, tg = grids
    rng = np.random.default_rng(8)
    occ = np.asarray(jg.occ) | (rng.random(jg.occ.shape) < 0.3)
    occ_xy = np.asarray(jg.occ_xy) | (rng.random(jg.occ_xy.shape) < 0.3)
    pos = _poses3(jg)
    for j, t in ((jg, tg),
                 (jg.replace(occ=jnp.asarray(occ), occ_xy=jnp.asarray(occ_xy)),
                  tg.replace(occ=torch.tensor(occ),
                             occ_xy=torch.tensor(occ_xy)))):
        if fn == "is_occupancy":
            want = jax.vmap(lambda p: jgrid.is_occupancy(j, p))(
                jnp.asarray(pos))
            got = tgrid.is_occupancy(t, torch.tensor(pos))
        elif fn == "is_occupancy_xy":
            want = jax.vmap(lambda p: jgrid.is_occupancy_xy(j, p))(
                jnp.asarray(pos))
            got = tgrid.is_occupancy_xy(t, torch.tensor(pos))
        else:
            want = jgrid.is_occupancy_xy_batch(j, jnp.asarray(pos[:, 0]),
                                               jnp.asarray(pos[:, 1]))
            got = tgrid.is_occupancy_xy_batch(
                t, torch.tensor(pos[:, 0]).reshape(20, 30),
                torch.tensor(pos[:, 1]).reshape(20, 30)).reshape(-1)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(np.asarray(want).sum()) < len(pos)
    assert np.asarray(want)[100:120].all()           # out of map: occupied


@pytest.mark.parametrize("branch", ["packed16", "pair", "bare"])
def test_terrain_sigma_cm_matches_jax(grids, branch):
    """Each branch against the same branch of the JAX package (1e-12), and
    against the exact trilinear field: exactly for the pair table and the
    bare grid, within the f16 table's error for packed16."""
    jg, tg = grids
    drop = {"packed16": {}, "pair": dict(data_packed16=None),
            "bare": dict(data_packed16=None, data_pair=None)}[branch]
    j, t = jg.replace(**drop), tg.replace(**drop)
    px, py, yaw = _poses(jg, seed=9)
    want = jgrid.terrain_sigma_cm(j, *map(jnp.asarray, (px, py, yaw)))
    got = tgrid.terrain_sigma_cm(t, *map(torch.tensor, (px, py, yaw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    exact = jax.vmap(lambda p: jgrid.terrain_sigma(jg, p))(
        jnp.asarray(np.stack([px, py, yaw], 1)))
    # sigma <= ~0.1 on the hill; one f16 rounding is 2^-11 relative, and
    # the low-y strip blends differently on the packed path
    tol = 1e-4 if branch == "packed16" else 1e-12
    keep = np.ones(len(px), bool)
    if branch == "packed16":
        keep[40:60] = False
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(exact)[keep],
                               rtol=0, atol=tol)
    assert (got.numpy()[100:120] == 0).all()         # out of map: zero
    grid_shaped = tgrid.terrain_sigma_cm(
        t, *(torch.tensor(a).reshape(20, 30) for a in (px, py, yaw)))
    torch.testing.assert_close(grid_shaped.reshape(-1), got, rtol=0, atol=0)


def test_get_terrain_variables_batch_matches_jax(grids):
    jg, tg = grids
    pos = _poses3(jg, seed=10)
    want = jgrid.get_terrain_variables_batch(jg, jnp.asarray(pos))
    got = tgrid.get_terrain_variables_batch(tg, torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    want_v = jgrid.get_terrain_batch(jg, jnp.asarray(pos))
    got_v = tgrid.get_terrain_batch(tg, torch.tensor(pos))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-12)
