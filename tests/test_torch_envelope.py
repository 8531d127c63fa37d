"""The JAX-envelope helper of the parity tests (tests/torch_parity.py:
`jax_envelope`, `Envelope`, `assert_in_envelope`) on a toy batched
function with a known branching point: lane b takes one step more when
x0[b].sum() > 1, so a lane whose sum sits at 1 flips its count under
perturbations of x0 at the scale of rounding."""

import numpy as np
import pytest

from torch_parity import (RUNS_PER_LANE, ULP_EPS, Envelope,
                          assert_in_envelope, jax_envelope)


class Toy:
    """A batched 'solve': per lane a step count (1, or 2 past the
    branching point) and an x that depends on the branch."""

    def __init__(self, steps, x):
        self.steps, self.x = steps, x


def toy(x, offset=None):
    s = x.sum(1) + (0.0 if offset is None else offset)
    steps = np.where(s > 1.0, 2, 1)
    return Toy(steps, x * steps[:, None] + 1e-3 * np.sin(1e6 * x))


def read_toy(r):
    return r.steps[:, None].astype(np.int64), {"x": r.x}


# lane 0 sits on the branching point, lane 1 far from it
X0 = np.array([[0.5, 0.5], [0.2, 0.3]])


@pytest.fixture(scope="module")
def env():
    return jax_envelope(toy, X0, np.zeros(2), read=read_toy, lanes=True,
                        wrap=np.asarray)


def test_envelope_finds_both_branches_of_the_moving_lane(env):
    """The moving lane gets a fixed sample, the other only the runs at
    x0 and 1 ulp from it; row 0 is the run at x0."""
    assert env.counts(0) == {(1,), (2,)}
    assert env.counts(1) == {(1,)}
    assert len(env.rows[0]) == 1 + len(ULP_EPS) + RUNS_PER_LANE
    assert len(env.rows[1]) == 1 + len(ULP_EPS)
    np.testing.assert_array_equal(env.at_x0("x"), toy(X0).x)
    # the far lane's x moves by ~1e-15 relative under 1-ulp changes
    assert 0.0 < env.spread(1, "x") < 1e-12


def test_result_inside_the_envelope_passes(env):
    """Another summation order's result, on either side of the branching
    point: x0 moved by ~2 ulps each way."""
    for e, steps in ((5e-16, 2), (-5e-16, 1)):
        c, v = read_toy(toy(X0 * (1.0 + e)))
        assert c[0, 0] == steps
        assert_in_envelope(env, c, v)


def test_counts_no_jax_run_shows_fail(env):
    c, v = read_toy(toy(X0))
    c[1] = 2              # the far lane never takes the second step
    with pytest.raises(AssertionError, match="lane 1: counts"):
        assert_in_envelope(env, c, v)


def test_value_outside_the_widened_range_fails(env):
    c, v = read_toy(toy(X0))
    w = max(1e-8, 10.0 * env.spread(1, "x"))
    v["x"][1] += 2.0 * w
    with pytest.raises(AssertionError, match="lane 1: x"):
        assert_in_envelope(env, c, v)
    v["x"][1] -= 1.5 * w  # back inside the widening
    assert_in_envelope(env, c, v)


def test_floor_is_a_tolerance_around_jax_not_a_limit():
    """A run set whose values never move: the range is one point, and the
    floor is the whole tolerance."""
    e = Envelope(1)
    for _ in range(3):
        e.add(np.array([[3]]), {"v": np.array([2.0])})
    assert e.spread(0, "v") == 0.0
    assert not e.misses(np.array([[3]]), {"v": np.array([2.0 + 5e-9])})
    assert e.misses(np.array([[3]]), {"v": np.array([2.0 + 2e-8])})
    assert not e.misses(np.array([[3]]), {"v": np.array([2.0 + 2e-8])},
                        floor={"v": 1e-7})
