"""Thin ring around a central sink.  Counterpart of
`summersph_tpu/models/ring.py`: a narrow annulus of gas on circular
Keplerian orbits, which pressure and viscosity spread while the angular
momentum is conserved.  The same numpy generator calls, so the same seed
gives the same arrays in either package."""

from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..state import Particles, SimState, Sinks
from ..utils.units import G


def ring_ic(
    n: int = 4000,
    r0: float = 50.0,
    width: float = 5.0,
    m_ring: float = 0.01,
    m_star: float = 1.0,
    u0: float = 1.0e-4,
    alpha0: float = 0.1,
    h0: float = 2.0,
    sink_radius: float = 3.5,
    cfg: SimConfig | None = None,
    capacity: int | None = None,
    seed: int = 0,
    device="cuda",
):
    """Returns (SimState, SimConfig), the state on `device` (the card
    unless the caller asks for another)."""
    cfg = cfg or SimConfig(
        fixed_h=h0, gravity="none", gamma=1.4,
        bounding_size=1500.0, end_time=100.0, sink_radius=sink_radius,
    )
    rng = np.random.default_rng(seed)
    r = r0 + width * rng.standard_normal(n) * 0.5
    r = np.clip(r, r0 - 2 * width, r0 + 2 * width)
    phi = 2.0 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros(n)], axis=1)
    vk = np.sqrt(G * m_star / r)
    vel = np.stack([-vk * np.sin(phi), vk * np.cos(phi), np.zeros(n)], axis=1)

    dtype = cfg.np_dtype()
    p = Particles.create(pos=pos, vel=vel, mass=np.full(n, m_ring / n),
                         u=np.full(n, u0), alpha=np.full(n, alpha0), h=h0,
                         capacity=capacity, dtype=dtype, device=device)
    s = Sinks.create(pos=np.zeros((1, 3)), vel=np.zeros((1, 3)),
                     mass=[m_star], radius=[sink_radius],
                     capacity=cfg.sink_capacity, dtype=dtype, device=device)
    return SimState.create(p, s, dt=cfg.dt_init), cfg


__all__ = ["ring_ic"]
