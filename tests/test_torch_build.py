"""Port parity of the map builder and its host-side IO: point-cloud and mesh
readers and writers, map caches, bucketing, KD seeds, the closed-form 3x3
eigensolver, the plane fits and `construct_map` in its three modes, against
the JAX package on the CPU.

The cloud: ~30,000 points sampled from a triangulated analytic hill (the
port's `hill_height`, lifted 0.1 m) plus one dense 600-point trunk, built
at the coarse `MapConfig(xy_resolution=0.4, yaw_resolution=0.8)`.

Tolerances: the sweeps run in float32 in both packages and sum in different
orders, so every cell of a fit or a map is held within 2e-3 of JAX's (the
JAX package's own tolerance between its modes, tests/test_build.py) and the
median within 1e-6; the host-side arrays (cloud, buckets, seeds, samples)
must be equal; the float64 eigensolver within 1e-12 of JAX's.
"""

import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uneven_planner_tpu import api as japi
from uneven_planner_tpu.config import MapConfig as JMapConfig
from uneven_planner_tpu.terrain import build as jbuild
from uneven_planner_tpu.terrain import io as jio
from uneven_planner_tpu.terrain import mesh as jmesh
from uneven_planner_tpu_torch import api
from uneven_planner_tpu_torch.config import MapConfig
from uneven_planner_tpu_torch.kernels import gather
from uneven_planner_tpu_torch.terrain import build, io, mesh
from uneven_planner_tpu_torch.terrain.synthetic import hill_height

CPU = torch.device("cpu")
CFG = MapConfig(xy_resolution=0.4, yaw_resolution=0.8)
JCFG = JMapConfig(xy_resolution=0.4, yaw_resolution=0.8)
# Every cell: the bound the JAX package holds its own two build modes of
# one cloud to (tests/test_build.py:158, :164).  In float32 a cell's normal
# and sigma come from the smallest eigenvalue of a 3x3 covariance, which a
# rounding of the covariance moves by up to ~sqrt(eps_f32) lambda_max =
# 3.5e-4 lambda_max on near-planar ellipsoids, ~1e-3 in sigma = 3
# lambda_min / trace (see SIGMA_ROUNDING): 2e-3 is twice that.
TOL_CELL = 2e-3
# The median cell, a well-conditioned fit: 8 float32 ulps (1.2e-7 each)
# of a value of order 1; the two builds differ by rounding only.
TOL_MEDIAN = 1e-6
# float64, the same closed form operation for operation
# (build.py:_eigh3_smallest): a few thousand ulps of eigenvalues of order 1
TOL_EIGH_JAX = 1e-12
# float64 against numpy's eigh: the JAX package's own bound
# (tests/test_build.py:26)
TOL_EIGH_NUMPY = 1e-8
# sigma = 3 lambda_min / trace is ~0 on a noise-free surface, and exactly 0
# where an ellipsoid holds two points, where the float32 closed form of
# both packages puts lambda_min up to ~sqrt(eps_f32) lambda_max to either
# side of 0: sigma down to ~-3 sqrt(eps_f32) = -7.3e-4 (the JAX package's
# build of this cloud reaches -2.2e-6; tests/test_build.py allows -1e-6 on
# the noisy desert scan)
SIGMA_ROUNDING = 1e-3
TRUNK_XY = (1.13, -0.87)
MODES = ["yawshare", "xyz", "xy"]


def hill_mesh(step=0.04, half=5.6, lift=0.1):
    """The hill surface triangulated on a square grid of `step` spacing."""
    xs = np.arange(-half, half + 1e-9, step)
    n = len(xs)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X, Y, hill_height(X, Y) + lift], -1).reshape(-1, 3)
    i = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([i, i + n, i + 1], 1),
                            np.stack([i + 1, i + n, i + n + 1], 1)])
    return verts, faces


@pytest.fixture(scope="module")
def surface():
    return hill_mesh()


@pytest.fixture(scope="module")
def cloud(surface):
    pts = io.voxel_downsample(mesh.sample_surface(*surface, 30_000, seed=0))
    rng = np.random.default_rng(4)
    trunk = np.stack([TRUNK_XY[0] + rng.normal(0, 0.03, 600),
                      TRUNK_XY[1] + rng.normal(0, 0.03, 600),
                      0.1 + rng.uniform(0.0, 3.0, 600)], axis=1)
    return np.concatenate([pts, trunk])


def _close(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.isfinite(got).all()
    assert d.max() <= TOL_CELL, d.max()
    assert np.median(d) <= TOL_MEDIAN, np.median(d)


# ---------------------------------------------------------------------------
# io and mesh
# ---------------------------------------------------------------------------

def _write_binary_pcd(path, pts):
    pts = np.asarray(pts, np.float32)
    with open(path, "wb") as f:
        f.write(("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
                 "TYPE F F F F\nCOUNT 1 1 1 1\n"
                 f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\n"
                 "DATA binary\n").encode())
        body = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
        f.write(body.tobytes())


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_pcd_round_trip_matches_jax(tmp_path, cloud, kind):
    path = str(tmp_path / f"c_{kind}.pcd")
    pts = cloud[::7]
    if kind == "ascii":
        mesh.save_pcd(path, pts)
    else:
        _write_binary_pcd(path, pts)
    got = io.read_pcd(path)
    np.testing.assert_array_equal(got, jio.read_pcd(path))
    assert got.shape == pts.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, pts.astype(np.float32),
                               atol=1e-6 if kind == "ascii" else 0)


def test_missing_pcd_names_its_path(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"maps/desert\.pcd"):
        io.load_scene_cloud("desert", str(tmp_path / "maps"))


def _write_stl(path, verts, faces, binary):
    tri = verts[faces]
    if binary:
        with open(path, "wb") as f:
            f.write(b"solid-looking binary header".ljust(80, b" "))
            f.write(struct.pack("<I", len(tri)))
            for t in tri:
                f.write(struct.pack("<3f", 0, 0, 1))
                f.write(np.asarray(t, "<f4").tobytes())
                f.write(b"\0\0")
    else:
        with open(path, "w") as f:
            f.write("solid hill\n")
            for t in tri:
                f.write("facet normal 0 0 1\nouter loop\n")
                for x, y, z in t.tolist():
                    f.write(f"vertex {x!r} {y!r} {z!r}\n")
                f.write("endloop\nendfacet\n")
            f.write("endsolid hill\n")


@pytest.mark.parametrize("kind", ["stl_ascii", "stl_binary", "obj"])
def test_mesh_readers_match_jax(tmp_path, kind):
    verts, faces = hill_mesh(step=0.8)
    path = str(tmp_path / ("m.obj" if kind == "obj" else f"{kind}.stl"))
    if kind == "obj":
        with open(path, "w") as f:
            for x, y, z in verts.tolist():
                f.write(f"v {x!r} {y!r} {z!r}\n")
            for a, b, c in faces[:-2]:
                f.write(f"f {a + 1}/1 {b + 1} {c + 1}\n")
            a, b, c = faces[-1]                 # a quad, as a fan
            f.write(f"f {a + 1} {b + 1} {c + 1} -1\n")
    else:
        _write_stl(path, verts, faces, binary=kind == "stl_binary")
    got_v, got_f = mesh.load_mesh(path)
    want_v, want_f = jmesh.load_mesh(path)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    got = mesh.mesh_to_cloud(path, n_points=5000, leaf=0.05, seed=3)
    np.testing.assert_array_equal(
        got, jmesh.mesh_to_cloud(path, n_points=5000, leaf=0.05, seed=3))
    tol = 1e-6 if kind == "stl_binary" else 0.0
    np.testing.assert_allclose(got_v[got_f[0]], verts[faces[0]], atol=tol)


@pytest.mark.parametrize("kind", ["csv", "npz"])
def test_map_caches_round_trip_and_match_jax(tmp_path, kind):
    data = np.random.default_rng(5).normal(size=(3, 4, 5, 4))
    path = str(tmp_path / f"m.{kind}")
    if kind == "csv":
        io.save_map_csv(path, data)
        got = io.load_map_csv(path, (3, 4, 5))
        want = jio.load_map_csv(path, (3, 4, 5))
    else:
        io.save_map_npz(path, data)
        got, want = io.load_map_npz(path), jio.load_map_npz(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)


def test_sampling_and_voxel_filter_match_jax(surface, cloud):
    raw = mesh.sample_surface(*surface, 30_000, seed=0)
    np.testing.assert_array_equal(raw,
                                  jmesh.sample_surface(*surface, 30_000,
                                                       seed=0))
    np.testing.assert_array_equal(io.voxel_downsample(raw),
                                  jio.voxel_downsample(raw))
    np.testing.assert_array_equal(io.crop_box(cloud), jio.crop_box(cloud))
    assert len(io.crop_box(cloud)) == len(cloud)      # the lift keeps all
    assert 25_000 < len(cloud) < 31_000


def test_load_scene_cloud_matches_jax(tmp_path, cloud):
    maps = str(tmp_path)
    mesh.save_pcd(os.path.join(maps, "dunes.pcd"), cloud)
    np.testing.assert_array_equal(io.load_scene_cloud("dunes", maps),
                                  jio.load_scene_cloud("dunes", maps))


# ---------------------------------------------------------------------------
# buckets, seeds, eigensolver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("capacity", [None, 7])
def test_buckets_match_jax(cloud, dims, capacity):
    make, jmake = ((build.build_buckets, jbuild.build_buckets) if dims == 2
                   else (build.build_buckets3d, jbuild.build_buckets3d))
    b = make(cloud, CFG, capacity=capacity, device=CPU)
    jb = jmake(cloud, JCFG, capacity=capacity)
    assert b.nb == tuple(jb.nb) and b.size == jb.size
    assert b.origin == tuple(jb.origin)
    np.testing.assert_array_equal(b.table.numpy().reshape(
        np.asarray(jb.bucket_idx).shape), np.asarray(jb.bucket_idx))
    xyz = np.stack([np.asarray(jb.px), np.asarray(jb.py), np.asarray(jb.pz)],
                   1)
    np.testing.assert_array_equal(b.cloud[:, :3].numpy(), xyz)
    assert (b.cloud[:, 3] == 0).all() and b.cloud.dtype == torch.float32
    table = b.table.numpy()
    np.testing.assert_array_equal(b.counts.reshape(-1),
                                  (table < len(cloud)).sum(1))
    if capacity:
        assert table.shape[1] == capacity


def test_window_bound_is_the_fullest_window(cloud):
    b = build.build_buckets3d(cloud, CFG, device=CPU)
    c = b.counts
    want = max(c[i:i + 5, j:j + 5, k:k + 6].sum()
               for i in range(c.shape[0] - 4) for j in range(c.shape[1] - 4)
               for k in range(c.shape[2] - 5))
    assert build.window_bound(b, (5, 5, 6)) == want


def test_nearest_z_seeds_match_jax(cloud):
    np.testing.assert_array_equal(build.nearest_z_seeds(cloud, CFG),
                                  jbuild.nearest_z_seeds(cloud, JCFG))


def test_eigh3_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    spd = [a @ a.T for a in rng.normal(size=(20, 3, 3))]
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    degenerate = [np.diag([1.0, 1.0, 2.0]),           # smallest repeated
                  q @ np.diag([0.5, 2.0, 2.0]) @ q.T,   # largest repeated
                  np.zeros((3, 3))]
    mats = np.stack(spd + degenerate)
    evals, vecs = build._eigh3_smallest(torch.tensor(mats))
    for m, e, v in zip(mats, evals.numpy(), vecs.numpy()):
        je, jv = jbuild._eigh3_smallest(jnp.asarray(m))
        np.testing.assert_allclose(e, np.asarray(je), rtol=0,
                                   atol=TOL_EIGH_JAX)
        np.testing.assert_allclose(v, np.asarray(jv), rtol=0,
                                   atol=TOL_EIGH_JAX)
    for m, e, v in zip(mats[:20], evals.numpy(), vecs.numpy()):
        w, V = np.linalg.eigh(m)
        np.testing.assert_allclose(e, w, rtol=TOL_EIGH_NUMPY, atol=1e-10)
        assert abs(float(v @ V[:, 0])) > 1 - TOL_EIGH_NUMPY
    # the tie: first of equal column norms, as jnp.argmax
    np.testing.assert_array_equal(np.abs(vecs[20].numpy()), [1.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# fits and maps
# ---------------------------------------------------------------------------

def _cells(n, seed):
    """Random cells [n, 3] float32, half of them within ~0.3 m of the trunk."""
    rng = np.random.default_rng(seed)
    cells = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                      rng.uniform(-np.pi, np.pi, n)], 1)
    cells[::2, :2] = np.asarray(TRUNK_XY) + rng.normal(0, 0.2, (n // 2, 2))
    return cells.astype(np.float32)


def _kd_seeds(cloud, xy, yaw):
    """The exact iteration-0 z seeds (`nearest_z_seeds`) of probes at cell
    xy [..., 2] and yaw [...], as the sweeps seed them."""
    from scipy.spatial import cKDTree
    probe = xy + CFG.probe_offset * np.stack([np.cos(yaw), np.sin(yaw)], -1)
    _, nn = cKDTree(cloud[:, :2]).query(probe.reshape(-1, 2))
    return cloud[nn, 2].astype(np.float32).reshape(probe.shape[:-1])


@pytest.mark.parametrize("mode", MODES)
def test_fits_match_jax(cloud, mode):
    """One batch of fits at iteration 0 and, from JAX's iteration-0
    values, at iteration 1.  The z seeds are the sweeps' own (exact KD);
    an ellipsoid placed at an arbitrary z can hold two or three collinear
    points, whose plane normal is undefined and then follows rounding."""
    t = lambda a: torch.from_numpy(np.array(a))
    if mode == "yawshare":
        xy = _cells(24, 1)[:, :2]
        yaws = ((np.arange(8) + 0.5) * CFG.yaw_resolution
                + CFG.map_origin[2]).astype(np.float32)
        seeds = _kd_seeds(cloud, xy[:, None, :], yaws[None, :])
        b = build.build_buckets3d(cloud, CFG, device=CPU)
        jb = jbuild.build_buckets3d(cloud, JCFG)
        jfit = jax.jit(jax.vmap(
            lambda c, p, s, first: jbuild._fit_yaw_block(
                c, jnp.asarray(yaws), p, s, jb, JCFG, first),
            in_axes=(0, 0, 0, None)), static_argnums=3)
        prev = np.zeros((24, 8, 4), np.float32)
        for first in (True, False):
            want = np.asarray(jfit(xy, prev, seeds, first))
            got = build._fit_yaw_block(t(xy), t(yaws), t(prev), t(seeds), b,
                                       CFG, first)
            _close(got.numpy(), want)
            prev = want
        return
    cells = _cells(200, 3)
    if mode == "xyz":
        b = build.build_buckets3d(cloud, CFG, device=CPU)
        jb = jbuild.build_buckets3d(cloud, JCFG)
        seeds = _kd_seeds(cloud, cells[:, :2], cells[:, 2])
        jfit = jax.jit(jax.vmap(lambda c, p, s, first: jbuild._fit_cell3d(
            c, p, s, jb, JCFG, first), in_axes=(0, 0, 0, None)),
            static_argnums=3)
        port = lambda c, p, first: build._fit_cell3d(c, p, t(seeds), b, CFG,
                                                     first)
        run = lambda p, first: jfit(cells, p, seeds, first)
    else:
        b = build.build_buckets(cloud, CFG, device=CPU)
        jb = jbuild.build_buckets(cloud, JCFG)
        jfit = jax.jit(jax.vmap(lambda c, p, first: jbuild._fit_cell(
            c, p, jb, JCFG, first), in_axes=(0, 0, None)), static_argnums=2)
        port = lambda c, p, first: build._fit_cell(c, p, b, CFG, first)
        run = lambda p, first: jfit(cells, p, first)
    prev = np.zeros((200, 4), np.float32)
    for first in (True, False):
        want = np.asarray(run(prev, first))
        _close(port(t(cells), t(prev), first).numpy(), want)
        prev = want
    # the fits near the trunk see it: some cells there are rough
    assert (want[::2, 1] > 0.05).any()


@pytest.mark.parametrize("mode", MODES)
def test_construct_map_matches_jax(cloud, mode):
    want = np.asarray(jbuild.construct_map(cloud, JCFG, chunk=8192,
                                           mode=mode).data)
    gather.reset_launches()
    grid = build.construct_map(cloud, CFG, mode=mode, device=CPU)
    assert gather.launches["gather_rows"] == 0        # no kernel on the CPU
    assert grid.data.shape == CFG.voxel_num + (4,)
    assert grid.data.dtype == torch.float32
    _close(grid.data.numpy(), want)
    sig = grid.data[..., 1]
    assert sig.min() >= -SIGMA_ROUNDING and sig.max() <= 1 + 1e-6
    assert 0.0 < grid.occ.float().mean() < 0.9
    # a dispatch of a few hundred fits gives the same map, up to the
    # summation order of its shorter candidate lists
    small = build.construct_map(cloud, CFG, chunk=300, mode=mode, device=CPU)
    _close(small.data.numpy(), grid.data.numpy())


def test_construct_map_defaults_to_cuda_and_raises_without_it(cloud,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build.construct_map(cloud, CFG)
    with pytest.raises(ValueError, match="mode"):
        build.construct_map(cloud, CFG, mode="voxels", device=CPU)
    far = dataclasses.replace(CFG, probe_offset=0.25)
    with pytest.raises(ValueError, match="probe_offset"):
        build.construct_map(cloud, far, device=CPU)


def test_load_or_build_scene_builds_a_pcd_scene(cloud, tmp_path,
                                                 monkeypatch):
    """The point-cloud branch: build from the scene's cloud, write the npz
    cache, read it back the second time; the same map as the JAX
    package's, and the same cache."""
    def small(make):
        return lambda name: dataclasses.replace(make(name), map=(
            dataclasses.replace(make(name).map, xy_resolution=0.4,
                                yaw_resolution=0.8)))

    monkeypatch.setattr(io, "load_scene_cloud", lambda name: cloud)
    monkeypatch.setattr(jio, "load_scene_cloud", lambda name: cloud)
    monkeypatch.setattr(api, "scene_config", small(api.scene_config))
    monkeypatch.setattr(japi, "scene_config", small(japi.scene_config))
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    scfg, grid = api.load_or_build_scene("desert", cache_dir=str(mine),
                                         device=CPU)
    _, jgrid_ = japi.load_or_build_scene("desert", cache_dir=str(theirs))
    assert scfg.name == "desert" and grid.voxel_num == CFG.voxel_num
    _close(grid.data.numpy(), np.asarray(jgrid_.data))
    cache = io.load_map_npz(str(mine / "desert.npz"))
    _close(cache, io.load_map_npz(str(theirs / "desert.npz")))
    np.testing.assert_array_equal(cache, grid.data.numpy())
    monkeypatch.setattr(io, "load_scene_cloud", None)   # now from the cache
    _, again = api.load_or_build_scene("desert", cache_dir=str(mine),
                                       dtype=np.float64, device=CPU)
    assert again.data.dtype == torch.float64
    np.testing.assert_array_equal(again.data.numpy(), cache)
    np.testing.assert_array_equal(again.occ.numpy(), grid.occ.numpy())
