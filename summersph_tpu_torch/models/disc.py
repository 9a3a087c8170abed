"""Keplerian disc / sphere initial conditions.  Counterpart of `disc_ic`
and `collapse_ic` in `summersph_tpu/models/disc.py`: the same numpy
sampler, so the same seed gives the same initial state, bit for bit, in
either package."""

from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..state import Particles, SimState, Sinks
from ..utils.units import G


def _uniform_sphere(n: int, r_max: float, rng: np.random.Generator):
    """Vectorised rejection sampling of n points uniform in a ball."""
    pts = np.empty((0, 3))
    while len(pts) < n:
        cand = 2.0 * r_max * (rng.random((2 * n, 3)) - 0.5)
        keep = np.sum(cand ** 2, axis=1) <= r_max ** 2
        pts = np.concatenate([pts, cand[keep]])
    return pts[:n]


def disc_ic(
    n: int = 12000,
    r_max: float = 100.0,
    m_disc: float = 5.0,
    m_star: float = 5.0,
    u0: float = 0.25,
    alpha0: float = 0.1,
    rotation: str = "keplerian",   # keplerian|rigid|rigidbody|none
    v_circ: float = 1.0,
    aspect: float = 1.0,           # z flattening: 1 = sphere, < 1 = disc
    h0: float = 2.5,
    sink_radius: float = 3.5,
    cfg: SimConfig | None = None,
    capacity: int | None = None,
    sink_capacity: int | None = None,
    seed: int = 0,
    device="cuda",
):
    """A (rotating) sphere or disc of gas with an optional central sink of
    mass m_star.  Returns (SimState, SimConfig), the state on `device`
    (the card unless the caller asks for another)."""
    cfg = cfg or SimConfig(
        fixed_h=h0, gravity="none", gamma=1.4,
        bounding_size=max(15.0 * r_max, 1500.0),
        end_time=100.0, sink_radius=sink_radius,
    )
    rng = np.random.default_rng(seed)
    pos = _uniform_sphere(n, r_max, rng)
    pos[:, 2] *= aspect

    r_cyl = np.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    r_safe = np.maximum(r_cyl, 1.0e-8 * r_max)
    if rotation == "keplerian":
        vmag = np.sqrt(G * max(m_star, 1.0e-30) / r_safe)
    elif rotation == "rigid":
        vmag = np.full(n, v_circ)
    elif rotation == "rigidbody":
        vmag = v_circ * r_cyl / r_max
    elif rotation == "none":
        vmag = np.zeros(n)
    else:
        raise ValueError(f"unknown rotation mode {rotation!r}")
    vel = np.stack([-vmag * pos[:, 1] / r_safe,
                    vmag * pos[:, 0] / r_safe,
                    np.zeros(n)], axis=1)

    dtype = cfg.np_dtype()
    p = Particles.create(
        pos=pos, vel=vel, mass=np.full(n, m_disc / n),
        u=np.full(n, u0), alpha=np.full(n, alpha0), h=h0,
        capacity=capacity, dtype=dtype, device=device)
    scap = sink_capacity if sink_capacity is not None else cfg.sink_capacity
    s = Sinks.create(pos=np.zeros((1, 3)), vel=np.zeros((1, 3)),
                     mass=[max(m_star, 0.0)],
                     radius=[sink_radius if m_star > 0 else 0.0],
                     capacity=scap, dtype=dtype, device=device)
    return SimState.create(p, s, dt=cfg.dt_init), cfg


def collapse_ic(n: int = 20000, r_max: float = 100.0, m_total: float = 5.0,
                device="cuda", **kw):
    """Self-gravitating collapse sphere: `disc_ic` with no central star
    (a zero-mass dummy sink) and, unless given, rigid rotation.  Returns
    (SimState, SimConfig) on `device` (the card unless the caller asks for
    another)."""
    kw.setdefault("rotation", "rigid")
    kw.setdefault("m_star", 0.0)
    return disc_ic(n=n, r_max=r_max, m_disc=m_total, device=device, **kw)


__all__ = ["disc_ic", "collapse_ic"]
