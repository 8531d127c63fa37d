"""Fleet cells: every lane a robot tracking the figure-eight under the
program's MPC, one control tick of the whole fleet a unit.

A unit is `sim.rollout.tick` on every lane, ended by reading the lanes'
commands on the host, as a deployed controller reads its command every
tick.  Episodes of `episode_ticks` ticks start from start states drawn from
the seed.  On ticks drawn from the seed a few lanes' inputs (state, carried
inputs, time) and outputs (command, next state) are kept; after the window
the plain reference (`reference/fleet.py`) works each of those ticks out
again from the same inputs.
"""

from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import traffic as gen  # noqa: E402
from benchmark.reference import fleet as ref  # noqa: E402
from benchmark.reference.arith import Arith  # noqa: E402


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic = cell.traffic
        self.mpc_dict = cell.config["mpc"]
        self.lanes = self.traffic["lanes"]
        self.samples = []

    # -- set-up ------------------------------------------------------------
    def setup(self) -> dict:
        """Imports, the trajectory on the device, and warm ticks of the
        window's shapes; returns the seconds of each part."""
        t0 = time.perf_counter()
        from uneven_planner_tpu_torch.config import MPCConfig
        from uneven_planner_tpu_torch.minco.traj import expand_traj
        from uneven_planner_tpu_torch.mpc import traj_msg
        from uneven_planner_tpu_torch.sim import rollout
        self.rollout = rollout
        # the configuration as it is run; JSON lists become the tuples the
        # frozen dataclass holds
        self.mpc = MPCConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in self.mpc_dict.items()})
        t = self.traffic["trajectory"]
        dtype = getattr(torch, self.cell.config["dtype"])
        self.dtype = dtype
        t1 = time.perf_counter()
        self.traj = expand_traj(traj_msg.figure_eight(
            t["max_vel"], t["pieces"], t["radius"], dtype=dtype,
            device=self.device), self.lanes)
        t2 = time.perf_counter()
        # warm-up: the window's shapes, from the warm-up's own start states
        # (the first tick builds or loads the kernels)
        self.state = self._episode(-1)
        for _ in range(self.traffic["warm_ticks"]):
            self._tick()
        self.tick_no = 0
        return {"program_import_s": t1 - t0, "trajectory_s": t2 - t1,
                "warm_ticks_s": time.perf_counter() - t2}

    def _episode(self, e: int):
        s0 = torch.as_tensor(gen.fleet_starts(self.traffic, self.seed, e),
                             dtype=self.dtype, device=self.device)
        return self.rollout.roll_init(s0, self.mpc)

    def _tick(self):
        self.state, out, res = self.rollout.tick(
            self.traj, self.state, self.mpc, self.traffic["ctrl_dt"],
            self.traffic["sqp_passes"], None)
        return out[1].cpu(), res

    # -- the window ----------------------------------------------------------
    def start_counting(self):
        self.count = torch.zeros(4, dtype=torch.int64, device=self.device)
        self.ticks = 0

    def unit(self) -> int:
        """One tick of the fleet; returns the lane-ticks it did."""
        k = self.tick_no
        if k % self.traffic["episode_ticks"] == 0:
            self.state = self._episode(k // self.traffic["episode_ticks"])
        lanes = gen.fleet_sampled_lanes(self.traffic, self.seed, k)
        if lanes is not None:
            idx = torch.as_tensor(lanes, device=self.device)
            pre = (self.state.state[idx], self.state.output[idx],
                   self.state.t[idx])
        cmd, res = self._tick()
        self.count += torch.stack([
            a.to(torch.int64) for a in (
                res.sqp_iters.sum(), res.qp_iters.sum(), res.sqp_iters.max(),
                (res.qp_failed > 0).any())])
        if lanes is not None:
            self.samples.append((k, lanes, *(a.cpu() for a in pre),
                                 cmd[lanes], self.state.state[idx].cpu()))
        self.tick_no += 1
        self.ticks += 1
        return self.lanes

    def counters(self) -> dict:
        c = self.count.tolist()
        return {"ticks": self.ticks, "lanes": self.lanes,
                "sqp_passes": c[0], "qp_iterations": c[1],
                "k6_launches": c[2], "failed_ticks": c[3],
                "qp_shape": self.mpc_dict}

    def attempted_failed(self):
        return self.ticks, int(self.count[3])

    def end_to_end(self, win) -> dict:
        return {"lane_ticks_per_s": win.rate()}

    def release(self):
        self.state = self.traj = None

    # -- the comparison ------------------------------------------------------
    def readings(self, arith: Arith | None = None) -> dict:
        """The numbers compared, over every kept tick: the program's
        against the float64 reference, or with `arith` the reference in
        that arithmetic (the control) in the program's place."""
        if not self.samples:
            raise RuntimeError("no tick was kept for the comparison")
        dev = self.device
        cat = lambda i: torch.cat([s[i] for s in self.samples]).to(dev)
        state, output, t = cat(2), cat(3), cat(4)
        cmd, nxt = cat(5).double(), cat(6).double()
        tr = self.traffic["trajectory"]
        traj = ref.figure_eight(tr["max_vel"], tr["pieces"], tr["radius"],
                                device=dev)
        args = (traj, state, output, t, self.mpc_dict,
                self.traffic["sqp_passes"], self.traffic["ctrl_dt"])
        cmd_ref, nxt_ref = ref.tick(*args, Arith())
        if arith is not None:
            cmd, nxt = (a.double() for a in ref.tick(*args, arith))
        m = self.mpc_dict
        hi = m["max_omega"] if m["model_type"] == 1 else m["max_steer"]
        bound = torch.tensor([m["max_speed"], hi], dtype=torch.float64,
                             device=dev)
        gap = lambda a, b: float(torch.nan_to_num(
            (a - b).abs(), nan=float("inf")).max())
        return {"cmd_gap": gap(cmd / bound, cmd_ref / bound),
                "next_state_gap": gap(nxt, nxt_ref),
                "compared": int(state.shape[0])}
