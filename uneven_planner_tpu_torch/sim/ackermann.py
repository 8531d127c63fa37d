"""Ackermann wheel-level actuation mapping (port of
`uneven_planner_tpu/sim/ackermann.py`).

The reference's cmdvel2gazebo node (carsim/scripts/cmdvel2gazebo.py) maps
(v, steer) commands to per-wheel velocities and per-side steering angles
from the inner/outer turning radii, with its velocity scale (linear.x /
0.05, :69), the ideal-middle-tire steer clamp (:44-56) and the dead-man
timeout (:40, 80-94).  Every function is elementwise over tensors of any
shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from uneven_planner_tpu_torch.terrain.grid import se3_lift

WHEEL_BASE = 0.26     # cmdvel2gazebo.py:30
TREAD_FRONT = 0.18    # :33
TREAD_REAR = 0.18     # :34
MAX_VEL = 1.5         # :37
VEL_SCALE = 0.05      # :69  (x = linear.x / 0.05)
MAX_STEER_INSIDE = 1.5  # :44
DEADMAN_TIMEOUT = 0.2   # :40


def max_ideal_steer() -> float:
    """Steer clamp for the ideal middle tire (cmdvel2gazebo.py:47-56)."""
    r_max = WHEEL_BASE / math.tan(MAX_STEER_INSIDE)
    r_ideal = r_max + TREAD_FRONT / 2.0
    return math.atan2(WHEEL_BASE, r_ideal)


class WheelCommand(NamedTuple):
    rear_left: torch.Tensor
    rear_right: torch.Tensor
    front_left: torch.Tensor
    front_right: torch.Tensor
    steer_left: torch.Tensor
    steer_right: torch.Tensor


def wheel_commands(v_cmd, steer_cmd, stale) -> WheelCommand:
    """The six wheel controllers' commands from (linear.x, angular.z) and
    the dead-man flag `stale` (cmdvel2gazebo.py:74-155).  The reference
    clamps to maxvel before overwriting x (dead code, :68-69); here, as in
    the JAX package, the clamp applies."""
    x = torch.clamp(v_cmd / VEL_SCALE, max=MAX_VEL)
    z = torch.clamp(steer_cmd, -max_ideal_steer(), max_ideal_steer())

    L = WHEEL_BASE
    sgn = torch.sign(z)
    r = L / torch.clamp(torch.abs(torch.tan(z)), min=1e-9)
    rl_rear = r - sgn * TREAD_REAR / 2.0
    rr_rear = r + sgn * TREAD_REAR / 2.0
    rl_front = r - sgn * TREAD_FRONT / 2.0
    rr_front = r + sgn * TREAD_FRONT / 2.0

    turning = torch.abs(z) > 0.0
    Lt = torch.full_like(r, L)
    rear_l = torch.where(turning, x * rl_rear / r, x)
    rear_r = torch.where(turning, x * rr_rear / r, x)
    steer_l = torch.where(turning, torch.atan2(Lt, rl_front) * sgn, z)
    steer_r = torch.where(turning, torch.atan2(Lt, rr_front) * sgn, z)
    front_l = torch.where(turning,
                          torch.sqrt(rr_front ** 2 + L ** 2) * x / r, x)
    front_r = torch.where(turning,
                          torch.sqrt(rl_front ** 2 + L ** 2) * x / r, x)
    off = lambda a: torch.where(stale, torch.zeros_like(a), a)
    return WheelCommand(
        rear_left=off(rear_l), rear_right=off(rear_r),
        front_left=off(front_l), front_right=off(front_r),
        steer_left=off(steer_l), steer_right=off(steer_r))


def rear_axle_pose(center_pose: torch.Tensor,
                   offset: float = 0.13) -> torch.Tensor:
    """Rear-axle poses [..., 3] from body-center poses [..., 3]
    (true_state_pub.py:49-53: -0.13 m along body x)."""
    x, y, yaw = center_pose.unbind(-1)
    return torch.stack([x - offset * torch.cos(yaw),
                        y - offset * torch.sin(yaw), yaw], dim=-1)


def quaternion_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternions [..., 4] of rotations [..., 3, 3] (the
    branchless trace form of the JAX package, safe for every orientation
    the terrain lift produces)."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + t, min=1e-12))
    s = 0.25 / torch.clamp(qw, min=1e-9)
    qx = (R[..., 2, 1] - R[..., 1, 2]) * s
    qy = (R[..., 0, 2] - R[..., 2, 0]) * s
    qz = (R[..., 1, 0] - R[..., 0, 1]) * s
    return torch.stack([qx, qy, qz, qw], dim=-1)


def world_tf(grid, se2_pose: torch.Tensor):
    """world -> base_footprint transforms of center poses [..., 3]:
    (translations [..., 3], quaternions [..., 4] xyzw), the SE(2) state
    lifted onto the terrain (the reference's world_tf_pub node,
    carsim/scripts/world_tf_pub.py:1-30)."""
    R, p = se3_lift(grid, se2_pose)
    return p, quaternion_from_rotation(R)
