"""The one traffic generator: every draw of a run comes from `--seed` and
the parameters of the cell's traffic file, so one seed gives the same
inputs on every run and every seed the same sizes.

Each kind of draw has a stream of its own, so adding a draw of one kind
moves no other.
"""

from __future__ import annotations

import numpy as np

FLEET_STARTS, FLEET_SAMPLES, FLEET_WARM = 1, 2, 3
CLOUD_SURFACE, CLOUD_TRUNKS, CLOUD_SHIFTS, BUILD_SAMPLES = 4, 5, 6, 7


def stream(seed: int, *key: int) -> np.random.Generator:
    """The generator of one stream of the seed (any whole number)."""
    return np.random.default_rng([seed % 2 ** 64, *key])


def fleet_starts(traffic: dict, seed: int, episode: int) -> np.ndarray:
    """[lanes, 3] float32 start states of one episode, spread about the
    trajectory's start pose as the controller's own benchmark draws them
    (the JAX package's MPC benchmark; chip_smoke.py's `_f8_starts`).
    Episode -1 is the warm-up's."""
    g = stream(seed, FLEET_WARM) if episode < 0 \
        else stream(seed, FLEET_STARTS, episode)
    n = traffic["lanes"]
    x0, y0, yaw0 = traffic["start_pose"]
    dxy, dyaw = traffic["start_spread"]
    s = np.empty((n, 3), np.float32)
    s[:, 0] = x0 + g.uniform(-dxy, dxy, size=n)
    s[:, 1] = y0 + g.uniform(-dxy, dxy, size=n)
    s[:, 2] = yaw0 + g.uniform(-dyaw, dyaw, size=n)
    return s


def fleet_sampled_lanes(traffic: dict, seed: int, tick: int):
    """The lanes of tick `tick` (counted from the window's first) whose
    inputs and outputs the check compares, or None: the first tick always,
    every other with the traffic's probability."""
    g = stream(seed, FLEET_SAMPLES, tick)
    if tick > 0 and g.random() >= traffic["check"]["tick_share"]:
        return None
    return np.sort(g.choice(traffic["lanes"], traffic["check"]["lanes"],
                            replace=False))


# ---------------------------------------------------------------------------
# map builds: the hill as a point cloud
# ---------------------------------------------------------------------------

def hill_height(x, y):
    """The synthetic hill's surface (the scene the hill configuration
    names: smooth hills on a 10 x 10 m patch)."""
    return (0.55 * np.exp(-((x - 1.5) ** 2 + (y - 1.0) ** 2) / 2.8)
            + 0.45 * np.exp(-((x + 2.0) ** 2 + (y + 2.2) ** 2) / 3.5)
            + 0.9 * np.exp(-((x + 0.5) ** 2 + (y - 3.0) ** 2) / 0.6)
            + 0.05 * np.sin(1.3 * x) * np.cos(1.1 * y))


def hill_cloud(traffic: dict, seed: int) -> np.ndarray:
    """[N, 3] float64 points of the hill as the reference's to_pcl flow
    makes them (chip_smoke.py's `build_cloud`): area-weighted uniform
    samples of the surface triangulated on a square grid of `mesh_step`,
    lifted by `lift`, and `trunks` vertical trunks of `trunk_points`
    points standing in `trunk_box`."""
    c = traffic["cloud"]
    xs = np.arange(-c["mesh_half"], c["mesh_half"] + 1e-9, c["mesh_step"])
    n = len(xs)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X, Y, hill_height(X, Y) + c["lift"]], -1) \
        .reshape(-1, 3)
    i = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([i, i + n, i + 1], 1),
                            np.stack([i + 1, i + n, i + n + 1], 1)])
    a, b, cc = (verts[faces[:, k]] for k in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(b - a, cc - a), axis=1)
    g = stream(seed, CLOUD_SURFACE)
    tri = g.choice(len(faces), size=c["samples"], p=areas / areas.sum())
    r1 = np.sqrt(g.random(c["samples"]))[:, None]
    r2 = g.random(c["samples"])[:, None]
    pts = (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * cc[tri]
    g = stream(seed, CLOUD_TRUNKS)
    (x0, x1), (y0, y1) = c["trunk_box"]
    k, m = c["trunks"], c["trunk_points"]
    cx, cy = g.uniform(x0, x1, k), g.uniform(y0, y1, k)
    trunks = [np.stack([x + g.normal(0, c["trunk_sd"], m),
                        y + g.normal(0, c["trunk_sd"], m),
                        hill_height(x, y) + c["lift"]
                        + g.uniform(0.0, c["trunk_height"], m)], 1)
              for x, y in zip(cx, cy)]
    return np.concatenate([pts] + trunks)


def build_shift(traffic: dict, seed: int, build: int) -> np.ndarray:
    """[3] rigid shift of build `build`'s cloud (-1: the warm-up's):
    every build of a run reads another cloud."""
    s = traffic["cloud"]["shift"]
    return stream(seed, CLOUD_SHIFTS, build + 1).uniform(-s, s, 3)


def build_sampled_cells(traffic: dict, seed: int, build: int, dims):
    """[n, 3] int64 cell indices (x, y, yaw) of build `build` that the
    check compares."""
    g = stream(seed, BUILD_SAMPLES, build)
    n = traffic["check"]["cells"]
    return np.stack([g.integers(0, d, n) for d in dims], 1)
