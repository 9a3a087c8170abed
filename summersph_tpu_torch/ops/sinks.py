"""Sink accretion and bounds culling.  Counterpart of `accrete` and
`cull_bounds` in `summersph_tpu/ops/sinks.py`, whose docstring lists the
deliberate corrections of the reference (nearest sink only, Euclidean
distance, accreted angular momentum kept in `spin`).

Sink creation and merging are later work: they run only with variable h
or `cfg.sink_merge_factor > 0`, both of which the port refuses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SimConfig
from ..state import PARK_POSITION, Particles, Sinks


def accrete(p: Particles, s: Sinks) -> Tuple[Particles, Sinks]:
    """Sinks absorb the live gas inside their accretion radius.

    Conserves mass, momentum and angular momentum: each particle goes to
    its nearest eligible sink, the sink moves to the combined centre of
    mass with the combined momentum, and the gas's angular momentum about
    the old sink frame adds to `spin`.  Accreted slots die and are parked.
    [S, N] layout with masked reductions, no scatter.
    """
    S = s.capacity
    d2 = torch.zeros((S, p.capacity), dtype=p.pos.dtype, device=p.pos.device)
    for c in range(3):
        d = s.pos[:, c][:, None] - p.pos[:, c][None, :]
        d2 = d2 + d * d
    eligible = (p.alive[None, :] & s.alive[:, None]
                & (s.mass[:, None] > 0.0)
                & (d2 < (s.radius * s.radius)[:, None]))

    nearest = torch.argmin(torch.where(eligible, d2, torch.inf), dim=0)
    accreted = torch.any(eligible, dim=0)
    claim = eligible & (torch.arange(S, device=p.pos.device)[:, None]
                        == nearest[None, :])                     # [S, N]

    m = torch.where(accreted, p.mass, 0.0)
    w = torch.where(claim, m[None, :], 0.0)                      # [S, N]
    msum = torch.sum(w, dim=1)

    def sink_field_at_gas(f):                                    # [S] -> [N]
        return torch.sum(torch.where(claim, f[:, None], 0.0), dim=0)

    px = [p.pos[:, c] for c in range(3)]
    vx = [p.vel[:, c] for c in range(3)]
    psum = torch.stack([torch.sum(w * vx[c][None, :], dim=1)
                        for c in range(3)], dim=-1)
    xsum = torch.stack([torch.sum(w * px[c][None, :], dim=1)
                        for c in range(3)], dim=-1)
    rx = [px[c] - sink_field_at_gas(s.pos[:, c]) for c in range(3)]
    rv = [vx[c] - sink_field_at_gas(s.vel[:, c]) for c in range(3)]
    cross = (rx[1] * rv[2] - rx[2] * rv[1],
             rx[2] * rv[0] - rx[0] * rv[2],
             rx[0] * rv[1] - rx[1] * rv[0])
    lsum = torch.stack([torch.sum(w * cross[c][None, :], dim=1)
                        for c in range(3)], dim=-1)

    new_mass = s.mass + msum
    grew = msum > 0.0
    inv = torch.where(grew, 1.0 / torch.where(grew, new_mass, 1.0), 0.0)
    new_pos = torch.where(grew[:, None],
                          (s.mass[:, None] * s.pos + xsum) * inv[:, None],
                          s.pos)
    new_vel = torch.where(grew[:, None],
                          (s.mass[:, None] * s.vel + psum) * inv[:, None],
                          s.vel)

    s = s.replace(mass=new_mass, pos=new_pos, vel=new_vel,
                  spin=s.spin + lsum)
    p = p.replace(
        alive=p.alive & ~accreted,
        mass=torch.where(accreted, 0.0, p.mass),
        pos=torch.where(accreted[:, None], PARK_POSITION, p.pos),
        vel=torch.where(accreted[:, None], 0.0, p.vel))
    return p, s


def cull_bounds(p: Particles, s: Sinks,
                cfg: SimConfig) -> Tuple[Particles, Sinks]:
    """Mask out particles and sinks outside the bounding box."""
    keep_p = p.alive & torch.all(torch.abs(p.pos) <= cfg.bounding_size,
                                 dim=-1)
    gone_p = p.alive & ~keep_p
    p = p.replace(
        alive=keep_p,
        mass=torch.where(gone_p, 0.0, p.mass),
        pos=torch.where(gone_p[:, None], PARK_POSITION, p.pos),
        vel=torch.where(gone_p[:, None], 0.0, p.vel))
    keep_s = s.alive & torch.all(torch.abs(s.pos) <= cfg.bounding_size,
                                 dim=-1)
    gone_s = s.alive & ~keep_s
    s = s.replace(
        alive=keep_s,
        mass=torch.where(gone_s, 0.0, s.mass),
        pos=torch.where(gone_s[:, None], PARK_POSITION, s.pos),
        vel=torch.where(gone_s[:, None], 0.0, s.vel))
    return p, s


__all__ = ["accrete", "cull_bounds"]
