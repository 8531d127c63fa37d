"""Keyboard teleoperation of the simulated car: the key-state machine
(port of `uneven_planner_tpu/sim/teleop.py`, without its interactive
terminal loop).

The reference teleop node (carsim/scripts/keyboard_control.py:1-137) drives
bang-bang commands (v = +-max_velocity, steer = +-max_steering_angle) while
a WASD key is held; pressing the opposite key cancels the other direction
(keydown semantics, :44-62).
"""

from __future__ import annotations

import dataclasses

MAX_VELOCITY = 1.0          # keyboard_control.py:101
MAX_STEER = 0.5             # keyboard_control.py:102


@dataclasses.dataclass
class TeleopState:
    """Held-key state [up, left, down, right] (keyboard_control.py:19)."""
    up: bool = False
    left: bool = False
    down: bool = False
    right: bool = False

    @property
    def active(self) -> bool:
        return self.up or self.left or self.down or self.right


def key_down(s: TeleopState, key: str) -> TeleopState:
    """keydown transition: opposite keys cancel
    (keyboard_control.py:44-62)."""
    if key == "w":
        return dataclasses.replace(s, up=True, down=False)
    if key == "a":
        return dataclasses.replace(s, left=True, right=False)
    if key == "s":
        return dataclasses.replace(s, down=True, up=False)
    if key == "d":
        return dataclasses.replace(s, right=True, left=False)
    return s


def key_up(s: TeleopState, key: str) -> TeleopState:
    """keyup transition (keyboard_control.py:30-41)."""
    m = {"w": "up", "a": "left", "s": "down", "d": "right"}
    if key in m:
        return dataclasses.replace(s, **{m[key]: False})
    return s


def command(s: TeleopState, max_velocity: float = MAX_VELOCITY,
            max_steer: float = MAX_STEER):
    """(v, steer), or None when no key is held (the reference publishes
    nothing then, keyboard_control.py:66-68)."""
    if not s.active:
        return None
    v = max_velocity if s.up else (-max_velocity if s.down else 0.0)
    st = max_steer if s.left else (-max_steer if s.right else 0.0)
    return (v, st)
