"""A run with the timed path broken underneath must come out not correct:
the rest of the run as it is, the look for a card skipped.  The faults a
cell can have (one card, so no exchange between chips): a step that
returns its state unchanged (the plant; the map's second sweep), half of
the batch left out (half the lanes; half the cells of each dispatch), and
an answer altered where it is produced (a command; a fit's z)."""

import time

import pytest
import torch

from benchmark import run
from benchmark.core import cells
from benchmark.tests.helpers import small_cell


def frozen_plant(orig):
    def plant_step(state, cmd, cfg, dt, cmd_valid=True):
        return state.clone()
    return plant_step


def half_the_lanes(orig):
    def mpc_step(now_state, xref, dref, output_prev, output_buff, cfg,
                 max_sqp_iter=None):
        h = now_state.shape[0] // 2
        res = orig(now_state[:h], xref[:h], dref[:h], output_prev[:h],
                   output_buff[:h], cfg, max_sqp_iter=max_sqp_iter)
        pad = lambda a: torch.cat([a, torch.zeros_like(a)]) if a is not None \
            else None
        return res._replace(**{k: pad(v) for k, v in res._asdict().items()})
    return mpc_step


def altered_command(orig):
    def mpc_step(*a, **k):
        res = orig(*a, **k)
        cmd = res.cmd.clone()
        cmd[-1, 0] += 0.01
        return res._replace(cmd=cmd)
    return mpc_step


# the sweep's step of each map-building mode, and where its previous
# values and its first-iteration flag sit among the arguments
SWEEP = {"xyz": ("_fit_cell3d", 1, 5), "yawshare": ("_fit_yaw_block", 2, 6),
         "auto": ("_fit_yaw_block", 2, 6), "xy": ("_fit_cell", 1, 4)}


def second_sweep_unchanged(orig, prev_at, first_at):
    def step(*a):
        if not a[first_at]:
            return a[prev_at].clone()
        return orig(*a)
    return step


def half_the_batch(orig, prev_at, first_at):
    def step(*a):
        out = orig(*a)
        h = out.shape[0] // 2
        out[h:] = a[prev_at][h:]
        return out
    return step


def altered_fit(orig, *_):
    def fit(idx, rows, M, wxy, z0, frames, cfg):
        out = orig(idx, rows, M, wxy, z0, frames, cfg).clone()
        out[..., 0] += 1e-3
        return out
    return fit


FLEET = {"state_unchanged": ("rollout", "plant_step", frozen_plant),
         "half_the_lanes": ("tracker", "mpc_step", half_the_lanes),
         "command_altered": ("tracker", "mpc_step", altered_command)}
BUILD = {"state_unchanged": ("build", None, second_sweep_unchanged),
         "half_the_lanes": ("build", None, half_the_batch),
         "command_altered": ("build", "_fit", altered_fit)}
CASES = [(w["name"], f) for w in cells.benchmark_json()["workloads"]
         for f in sorted(FLEET)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_broken_path_is_not_correct(workload, fault, monkeypatch,
                                    one_thread):
    from uneven_planner_tpu_torch.mpc import tracker
    from uneven_planner_tpu_torch.sim import rollout
    from uneven_planner_tpu_torch.terrain import build
    cell = small_cell(workload)
    if cell.traffic["driver"] == "fleet":
        mod, attr, make = FLEET[fault]
        extra = ()
    else:
        mod, attr, make = BUILD[fault]
        step, prev_at, first_at = SWEEP[cell.traffic["mode"]]
        attr, extra = attr or step, (prev_at, first_at)
    mod = {"rollout": rollout, "tracker": tracker, "build": build}[mod]
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr), *extra))
    args = run.parse(["--workload", workload, "--seed", "2400000003",
                      "--seconds", "0.3", "--trace", "0"])
    res = run.execute(args, torch.device("cpu"), cell=cell,
                      t_start=time.perf_counter())
    assert res["correct"] is False, res["checks"]
