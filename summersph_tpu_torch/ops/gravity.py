"""Sink gravity: direct, unsoftened gas<->sink and sink<->sink pulls.

Counterpart of `sink_gravity` in `summersph_tpu/ops/gravity.py`.  Gas
self-gravity (direct and TreePM) is later work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..state import Particles, Sinks
from ..utils.units import G


def sink_gravity(p: Particles,
                 s: Sinks) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc_gas [N, 3], acc_sink [S, 3]); masked pairs and coincident
    points contribute zero.  [S, N] per-component layout, no [N, S, 3]
    intermediate."""
    dxc = [s.pos[:, c][:, None] - p.pos[:, c][None, :] for c in range(3)]
    r2 = dxc[0] * dxc[0] + dxc[1] * dxc[1] + dxc[2] * dxc[2]
    valid = p.alive[None, :] & s.alive[:, None] & (r2 > 0.0)
    inv_r = torch.rsqrt(torch.clamp(r2, min=1.0e-12))
    w = torch.where(valid, G * (inv_r * inv_r * inv_r), 0.0)  # G/r^3

    wm_s = w * s.mass[:, None]                                 # [S, N]
    wm_p = w * torch.where(p.alive, p.mass, 0.0)[None, :]
    acc_gas = torch.stack([torch.sum(wm_s * dxc[c], dim=0)
                           for c in range(3)], dim=-1)
    acc_sink = torch.stack([-torch.sum(wm_p * dxc[c], dim=1)
                            for c in range(3)], dim=-1)

    ds = s.pos[:, None, :] - s.pos[None, :, :]                 # [S, S, 3]
    r2s = torch.sum(ds * ds, dim=-1)
    rs = torch.sqrt(r2s)
    vs = s.alive[:, None] & s.alive[None, :] & (rs > 0.0)
    ws = torch.where(vs, G / torch.where(vs, r2s * rs, 1.0), 0.0)
    acc_ss = -torch.sum((ws * s.mass[None, :])[..., None] * ds, dim=1)

    return (torch.where(p.alive[:, None], acc_gas, 0.0),
            torch.where(s.alive[:, None], acc_sink + acc_ss, 0.0))


__all__ = ["sink_gravity"]
