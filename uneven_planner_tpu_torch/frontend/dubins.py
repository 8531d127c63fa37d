"""Closed-form Dubins shortest paths on tensors (port of
`uneven_planner_tpu/frontend/dubins.py`).

The one-shot goal connection of the front end (kino_astar.h:242-271, radius
wheel_base/tan(max_steer)): all six words (LSL, RSR, LSR, RSL, RLR, LRL) are
evaluated with invalid words masked to +inf, and interpolation walks the
three segments of the best word.

Poses are [..., 3] tensors (x, y, yaw) whose leading dimensions broadcast;
`rho` is the minimum turning radius, a Python float.
"""

from __future__ import annotations

import math

import torch

from uneven_planner_tpu_torch.kernels.gather import gather_rows
from uneven_planner_tpu_torch.terrain.grid import _div

TWO_PI = 2.0 * math.pi

# segment type per word, encoded L=+1, S=0, R=-1
WORD_TYPES = ((1, 0, 1),     # LSL
              (-1, 0, -1),   # RSR
              (1, 0, -1),    # LSR
              (-1, 0, 1),    # RSL
              (-1, 1, -1),   # RLR
              (1, -1, 1))    # LRL


def _mod2pi(x):
    return x - TWO_PI * torch.floor(_div(x, TWO_PI))


def _word(ok, a, b, c):
    """[..., 3] segment lengths of one word, +inf where it is invalid."""
    w = torch.stack([a, b, c], dim=-1)
    return torch.where(ok[..., None], w, math.inf)


def _words(alpha, beta, d):
    """Segment lengths [..., 6, 3] (turn lengths in radians, straight in rho
    units) for the six Dubins words; invalid words -> inf.  Every sqrt and
    arccos argument is clamped before the call, so no NaN reaches the
    argmin over words."""
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    sb, cb = torch.sin(beta), torch.cos(beta)
    c_ab = torch.cos(alpha - beta)
    sqrt0 = lambda v: torch.sqrt(torch.clamp(v, min=0.0))
    const = lambda v: torch.full_like(d, v)

    tmp = d + sa - sb
    p2 = 2 + d * d - 2 * c_ab + 2 * d * (sa - sb)
    th = torch.atan2(cb - ca, tmp)
    lsl = _word(p2 >= 0, _mod2pi(-alpha + th), sqrt0(p2), _mod2pi(beta - th))

    tmp = d - sa + sb
    p2 = 2 + d * d - 2 * c_ab + 2 * d * (sb - sa)
    th = torch.atan2(ca - cb, tmp)
    rsr = _word(p2 >= 0, _mod2pi(alpha - th), sqrt0(p2), _mod2pi(-beta + th))

    p2 = -2 + d * d + 2 * c_ab + 2 * d * (sa + sb)
    p = sqrt0(p2)
    th = torch.atan2(-ca - cb, d + sa + sb) - torch.atan2(const(-2.0), p)
    lsr = _word(p2 >= 0, _mod2pi(-alpha + th), p,
                _mod2pi(-_mod2pi(beta) + th))

    p2 = d * d - 2 + 2 * c_ab - 2 * d * (sa + sb)
    p = sqrt0(p2)
    th = torch.atan2(ca + cb, d - sa - sb) - torch.atan2(const(2.0), p)
    rsl = _word(p2 >= 0, _mod2pi(alpha - th), p, _mod2pi(beta - th))

    tmp = (6.0 - d * d + 2 * c_ab + 2 * d * (sa - sb)) / 8.0
    p = _mod2pi(TWO_PI - torch.acos(torch.clamp(tmp, -1.0, 1.0)))
    th = alpha - torch.atan2(ca - cb, d - sa + sb) + _mod2pi(p / 2.0)
    rlr = _word(torch.abs(tmp) <= 1.0, _mod2pi(th), p,
                _mod2pi(alpha - beta - th + _mod2pi(p)))

    tmp = (6.0 - d * d + 2 * c_ab + 2 * d * (sb - sa)) / 8.0
    p = _mod2pi(TWO_PI - torch.acos(torch.clamp(tmp, -1.0, 1.0)))
    th = -alpha - torch.atan2(ca - cb, d + sa - sb) + p / 2.0
    lrl = _word(torch.abs(tmp) <= 1.0, _mod2pi(th), p,
                _mod2pi(_mod2pi(beta) - alpha - th + _mod2pi(p)))

    return torch.stack([lsl, rsr, lsr, rsl, rlr, lrl], dim=-2)


def _normalize(q0, q1, rho: float):
    dx = q1[..., 0] - q0[..., 0]
    dy = q1[..., 1] - q0[..., 1]
    d = _div(torch.sqrt(dx * dx + dy * dy), rho)
    th = torch.atan2(dy, dx)
    return _mod2pi(q0[..., 2] - th), _mod2pi(q1[..., 2] - th), d


def distance(q0, q1, rho: float) -> torch.Tensor:
    """Shortest Dubins path length between SE(2) poses: [...]."""
    w = _words(*_normalize(q0, q1, rho))
    return w.sum(-1).amin(-1) * rho


def _segment(x, y, th, seg_len, seg_type):
    """Advance normalized poses (rho=1) along one segment of the given type
    (a tensor of -1, 0, +1)."""
    sx, sy = x + seg_len * torch.cos(th), y + seg_len * torch.sin(th)
    lx = x + torch.sin(th + seg_len) - torch.sin(th)
    ly = y - torch.cos(th + seg_len) + torch.cos(th)
    rx = x - torch.sin(th - seg_len) + torch.sin(th)
    ry = y + torch.cos(th - seg_len) - torch.cos(th)
    straight, left = seg_type == 0, seg_type == 1
    pick = lambda s, l, r: torch.where(straight, s, torch.where(left, l, r))
    return (pick(sx, lx, rx), pick(sy, ly, ry),
            pick(th, th + seg_len, th - seg_len))


def sample_many(q0, q1, rho: float, ss: torch.Tensor) -> torch.Tensor:
    """Poses at the arc lengths `ss` [..., S] (world units) along the
    shortest path from q0 to q1 ([..., 3]): [..., S, 3].  The word is chosen
    once per pose pair."""
    w = _words(*_normalize(q0, q1, rho))                     # [..., 6, 3]
    best = w.sum(-1).argmin(-1)                              # first minimum
    pick = best[..., None, None].expand(best.shape + (1, 3))
    segs = torch.gather(w, -2, pick).squeeze(-2)             # [..., 3]
    types = gather_rows(
        torch.tensor(WORD_TYPES, dtype=torch.int32, device=w.device),
        best.reshape(-1)).reshape(best.shape + (3,))
    seg = lambda k: segs[..., k, None]
    typ = lambda k: types[..., k, None]

    t = _div(ss, rho)                                        # normalized
    zero = torch.zeros_like(t)
    pose = (zero, zero, zero + q0[..., 2, None])
    pose = _segment(*pose, torch.minimum(t, seg(0)), typ(0))
    pose = _segment(*pose, torch.minimum(
        torch.clamp(t - seg(0), min=0.0), seg(1)), typ(1))
    pose = _segment(*pose, torch.minimum(
        torch.clamp(t - seg(0) - seg(1), min=0.0), seg(2)), typ(2))
    return torch.stack([q0[..., 0, None] + pose[0] * rho,
                        q0[..., 1, None] + pose[1] * rho, pose[2]], dim=-1)


def sample(q0, q1, rho: float, s: torch.Tensor) -> torch.Tensor:
    """Pose [..., 3] at arc length s [...] along the shortest path."""
    return sample_many(q0, q1, rho, s[..., None]).squeeze(-2)
