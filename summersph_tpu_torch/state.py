"""Simulation state: frozen dataclasses of tensors.

Counterpart of `summersph_tpu/state.py`, with the same field names.  The
state has a fixed capacity: a dead particle has mass 0, sits at
`PARK_POSITION` far outside any domain, and has its dynamics frozen by the
`alive` mask, so deleting a particle never changes a shape.

`to_numpy` and `from_numpy` carry a state across to numpy and back.  The
dict is nested and holds numpy arrays under the JAX package's field names,
so a state built by either package can start the other.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

# Where dead particles are parked: finite, far outside any physical domain.
PARK_POSITION = 1.0e12

# SimState.stats slot names: per-step health counters (see the JAX state).
STATS_FIELDS = ("sph_window_overflow", "sph_clamped",
                "grav_window_overflow", "h_unconverged",
                "nonfinite", "sink_slots_full", "decomp_pressure")


class _Tree:
    """`replace` and `map` for the frozen state dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """Apply `fn` to every tensor field that is present."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})


@dataclasses.dataclass(frozen=True)
class Particles(_Tree):
    """Gas particles, structure of arrays."""

    pos: torch.Tensor        # [N, 3]
    vel: torch.Tensor        # [N, 3]
    acc: torch.Tensor        # [N, 3]
    mass: torch.Tensor       # [N]
    u: torch.Tensor          # [N] specific internal energy
    rho: torch.Tensor        # [N]
    pressure: torch.Tensor   # [N]
    cs: torch.Tensor         # [N] sound speed
    du: torch.Tensor         # [N] du/dt
    alpha: torch.Tensor      # [N] viscosity switch
    dalpha: torch.Tensor     # [N] dalpha/dt
    h: torch.Tensor          # [N] smoothing length
    omega: torch.Tensor      # [N] grad-h correction (1 with fixed h)
    alive: torch.Tensor      # [N] bool
    pid: torch.Tensor        # [N] int32 particle id, survives sorting
    u_c: Optional[torch.Tensor] = None      # Kahan carry of u (cfg.kahan_u)
    acc_ext: Optional[torch.Tensor] = None  # held PM force (cfg.pm_every)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    @classmethod
    def zeros(cls, capacity: int, dtype=torch.float32,
              device="cpu") -> "Particles":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            pos=torch.full((capacity, 3), PARK_POSITION, dtype=dtype,
                           device=device),
            vel=z(capacity, 3), acc=z(capacity, 3),
            mass=z(capacity), u=z(capacity), rho=z(capacity),
            pressure=z(capacity), cs=z(capacity), du=z(capacity),
            alpha=z(capacity), dalpha=z(capacity),
            h=torch.ones(capacity, dtype=dtype, device=device),
            omega=torch.ones(capacity, dtype=dtype, device=device),
            alive=torch.zeros(capacity, dtype=torch.bool, device=device),
            pid=torch.arange(capacity, dtype=torch.int32, device=device),
        )

    @classmethod
    def create(cls, pos, vel, mass, u, alpha=0.1, h=1.0,
               capacity: Optional[int] = None, dtype=torch.float32,
               device="cpu") -> "Particles":
        """A live particle set from array-likes, padded to `capacity`."""
        pos = torch.as_tensor(pos, dtype=dtype, device=device)
        n = pos.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < particle count {n}")

        def pad(x, shape, fill=0.0):
            x = torch.as_tensor(x, dtype=dtype, device=device)
            full = torch.full((cap,) + shape, fill, dtype=dtype,
                              device=device)
            full[:n] = x.expand((n,) + shape)
            return full

        alive = torch.zeros(cap, dtype=torch.bool, device=device)
        alive[:n] = True
        return cls.zeros(cap, dtype, device).replace(
            pos=pad(pos, (3,), PARK_POSITION), vel=pad(vel, (3,)),
            mass=pad(mass, ()), u=pad(u, ()), alpha=pad(alpha, ()),
            h=pad(h, (), fill=1.0), alive=alive)


@dataclasses.dataclass(frozen=True)
class Sinks(_Tree):
    """Sink particles, structure of arrays with a small fixed capacity."""

    pos: torch.Tensor      # [S, 3]
    vel: torch.Tensor      # [S, 3]
    acc: torch.Tensor      # [S, 3]
    spin: torch.Tensor     # [S, 3] accreted angular momentum
    mass: torch.Tensor     # [S]
    radius: torch.Tensor   # [S] accretion radius
    alive: torch.Tensor    # [S] bool

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    @classmethod
    def zeros(cls, capacity: int, dtype=torch.float32,
              device="cpu") -> "Sinks":
        z3 = torch.zeros((capacity, 3), dtype=dtype, device=device)
        z = torch.zeros(capacity, dtype=dtype, device=device)
        return cls(
            pos=torch.full((capacity, 3), PARK_POSITION, dtype=dtype,
                           device=device),
            vel=z3, acc=z3.clone(), spin=z3.clone(), mass=z,
            radius=z.clone(),
            alive=torch.zeros(capacity, dtype=torch.bool, device=device))

    @classmethod
    def create(cls, pos, vel, mass, radius, capacity: Optional[int] = None,
               dtype=torch.float32, device="cpu") -> "Sinks":
        pos = torch.atleast_2d(torch.as_tensor(pos, dtype=dtype,
                                               device=device))
        n = pos.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < sink count {n}")
        s = cls.zeros(cap, dtype, device)

        def put(base, x, shape):
            x = torch.as_tensor(x, dtype=dtype, device=device)
            out = base.clone()
            out[:n] = x.expand((n,) + shape)
            return out

        alive = torch.zeros(cap, dtype=torch.bool, device=device)
        alive[:n] = True
        return s.replace(pos=put(s.pos, pos, (3,)), vel=put(s.vel, vel, (3,)),
                         mass=put(s.mass, mass, ()),
                         radius=put(s.radius, radius, ()), alive=alive)


@dataclasses.dataclass(frozen=True)
class SimState(_Tree):
    """Particles + sinks + the (t, dt) clock + the per-step health counters
    (`stats`, int32[len(STATS_FIELDS)]).  `t` and `dt` are 0-d tensors on
    the particles' device."""

    particles: Particles
    sinks: Sinks
    t: torch.Tensor
    dt: torch.Tensor
    stats: torch.Tensor
    pm_r_s: Optional[torch.Tensor] = None   # held PM split (cfg.pm_every)

    @classmethod
    def create(cls, particles: Particles, sinks: Sinks, t=0.0,
               dt=1.0e-2) -> "SimState":
        dtype, device = particles.pos.dtype, particles.pos.device
        return cls(
            particles=particles, sinks=sinks,
            t=torch.tensor(t, dtype=dtype, device=device),
            dt=torch.tensor(dt, dtype=dtype, device=device),
            stats=torch.zeros(len(STATS_FIELDS), dtype=torch.int32,
                              device=device))

    def stats_dict(self):
        """Host-side view of the health counters."""
        return dict(zip(STATS_FIELDS, (int(v) for v in self.stats.tolist())))


def _fields_to_numpy(tree) -> dict:
    return {f.name: getattr(tree, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None}


def to_numpy(state: SimState) -> dict:
    """The state as a nested dict of numpy arrays under the JAX field names:
    {"particles": {...}, "sinks": {...}, "t", "dt", "stats"[, "pm_r_s"]}."""
    out = {"particles": _fields_to_numpy(state.particles),
           "sinks": _fields_to_numpy(state.sinks)}
    for name in ("t", "dt", "stats", "pm_r_s"):
        v = getattr(state, name)
        if v is not None:
            out[name] = v.detach().cpu().numpy()
    return out


def from_numpy(d: dict, device="cpu") -> SimState:
    """Inverse of `to_numpy`.  Arrays keep their dtypes; optional fields
    (`u_c`, `acc_ext`, `pm_r_s`) are taken when present and not None."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    def tree(cls, fields):
        return cls(**{f.name: t(fields[f.name])
                      for f in dataclasses.fields(cls)
                      if fields.get(f.name) is not None})

    pm_r_s = d.get("pm_r_s")
    return SimState(particles=tree(Particles, d["particles"]),
                    sinks=tree(Sinks, d["sinks"]), t=t(d["t"]),
                    dt=t(d["dt"]), stats=t(d["stats"]),
                    pm_r_s=None if pm_r_s is None else t(pm_r_s))


__all__ = ["Particles", "Sinks", "SimState", "PARK_POSITION", "STATS_FIELDS",
           "to_numpy", "from_numpy"]
