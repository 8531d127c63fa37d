"""SE(2) trajectory container (port of the `SE2Traj` of
`uneven_planner_tpu/minco/traj.py`; its evaluation and metrics are ported
with the general MINCO module).

Batched: coefficients are [B, Npieces, 6, Dim] physical ascending-power
coefficients and piece times [B, Npieces]."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SE2Traj(NamedTuple):
    """Piecewise-quintic SE(2) trajectories (xy and yaw pieces share the
    total duration but may differ in count, se2traj.hpp:819-830)."""
    c_xy: torch.Tensor    # [B, Nxy, 6, 2]
    ts_xy: torch.Tensor   # [B, Nxy]
    c_yaw: torch.Tensor   # [B, Nyaw, 6, 1]
    ts_yaw: torch.Tensor  # [B, Nyaw]

    @property
    def total_duration(self) -> torch.Tensor:
        return torch.minimum(self.ts_xy.sum(-1), self.ts_yaw.sum(-1))
