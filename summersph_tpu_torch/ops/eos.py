"""Adiabatic ideal-gas equation of state: P = (gamma - 1) u rho,
c_s = sqrt(gamma P / rho).  Counterpart of `summersph_tpu/ops/eos.py`."""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import Particles
from ..tracing import traced


@traced("eos")
def eos_update(p: Particles, cfg: SimConfig) -> Particles:
    rho = torch.where(p.alive, p.rho, 1.0)
    u = torch.where(p.alive, torch.clamp(p.u, min=0.0), 0.0)
    pressure = (cfg.gamma - 1.0) * u * rho
    cs = torch.sqrt(cfg.gamma * pressure / rho)
    return p.replace(pressure=torch.where(p.alive, pressure, 0.0),
                     cs=torch.where(p.alive, cs, 0.0))


__all__ = ["eos_update"]
