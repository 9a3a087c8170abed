"""1D Sod shock tube.  Counterpart of `summersph_tpu/models/sod.py`.

The tube is a quasi-1D line of particles evaluated with the full 3D kernel.
Along a line of spacing dx the 3D kernel sum gives rho_3D ~ (m / dx) C(h)
with C(h) = 1.5 / (pi h^2), so a particle mass m = rho_target pi h^2 dx /
1.5 reproduces the target 1D density profile.  Equal spacing and variable
mass keep the fixed smoothing length resolved on both sides of the 8:1
jump.  `sod_exact` is the exact Riemann solver (numpy, the JAX package's
code unchanged) that `sod_l2_density_error` measures against.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SimConfig
from ..state import Particles, SimState, Sinks

# Line integral of the 3D cubic-spline shape: 2 * int_0^2 w(q) dq.
_LINE_INTEGRAL = 1.5


@dataclasses.dataclass(frozen=True)
class SodSetup:
    rho_l: float = 1.0
    p_l: float = 1.0
    v_l: float = 0.0
    rho_r: float = 0.125
    p_r: float = 0.1
    v_r: float = 0.0
    gamma: float = 1.4
    x_min: float = -0.75
    x_max: float = 0.75
    x0: float = 0.0      # diaphragm position


def sod_config(n: int = 1000, setup: SodSetup = SodSetup(),
               h_over_dx: float = 2.0, **overrides) -> SimConfig:
    """The tube's config: fixed h = h_over_dx * dx, no gravity, and a dt
    floor scaled with the resolution (the v/a criterion is 0 for particles
    at rest, so the tube rides the floor, under the CFL time)."""
    dx = (setup.x_max - setup.x_min) / n
    h = h_over_dx * dx
    base = dict(
        gamma=setup.gamma,
        fixed_h=h,
        gravity="none",
        bounding_size=10.0,
        end_time=0.2,
        dt_init=0.03 * h,
        dt_max=0.08 * h,
        dt_min=0.03 * h,
        timestep_scale=0.25,
        n_saves=10,
    )
    base.update(overrides)
    return SimConfig(**base)


def sod_ic(n: int = 1000, setup: SodSetup = SodSetup(),
           cfg: SimConfig | None = None, capacity: int | None = None,
           device="cuda"):
    """Equal-spacing, variable-mass quasi-1D Sod line.  Returns (SimState,
    SimConfig), the state on `device` (the card unless the caller asks for
    another); the sink array holds the inert zero-mass dummy sink."""
    cfg = cfg or sod_config(n, setup)
    h = cfg.fixed_h
    dx = (setup.x_max - setup.x_min) / n
    x = setup.x_min + (np.arange(n) + 0.5) * dx
    left = x < setup.x0
    rho = np.where(left, setup.rho_l, setup.rho_r)
    pres = np.where(left, setup.p_l, setup.p_r)
    vel = np.where(left, setup.v_l, setup.v_r)

    mass = rho * np.pi * h * h * dx / _LINE_INTEGRAL
    u = pres / ((setup.gamma - 1.0) * rho)

    pos = np.stack([x, np.zeros(n), np.zeros(n)], axis=1)
    v3 = np.stack([vel, np.zeros(n), np.zeros(n)], axis=1)

    dtype = cfg.np_dtype()
    p = Particles.create(pos=pos, vel=v3, mass=mass, u=u, alpha=1.0, h=h,
                         capacity=capacity, dtype=dtype, device=device)
    s = Sinks.create(pos=np.zeros((1, 3)), vel=np.zeros((1, 3)),
                     mass=[0.0], radius=[0.0], capacity=1, dtype=dtype,
                     device=device)
    return SimState.create(p, s, dt=cfg.dt_init), cfg


def sod_exact(x, t, setup: SodSetup = SodSetup()):
    """Exact Riemann solution (rho, v, P) sampled at positions x, time t."""
    g = setup.gamma
    rl, pl, ul = setup.rho_l, setup.p_l, setup.v_l
    rr, pr, ur = setup.rho_r, setup.p_r, setup.v_r
    al = np.sqrt(g * pl / rl)
    ar = np.sqrt(g * pr / rr)

    def fk(p, pk, rk, ak):
        if p > pk:  # shock
            A = 2.0 / ((g + 1.0) * rk)
            B = (g - 1.0) / (g + 1.0) * pk
            f = (p - pk) * np.sqrt(A / (p + B))
            df = np.sqrt(A / (p + B)) * (1.0 - (p - pk) / (2.0 * (p + B)))
        else:  # rarefaction
            f = 2.0 * ak / (g - 1.0) * ((p / pk) ** ((g - 1.0) / (2.0 * g)) - 1.0)
            df = (p / pk) ** (-(g + 1.0) / (2.0 * g)) / (rk * ak)
        return f, df

    # Newton for p_star
    p = max(1.0e-8, 0.5 * (pl + pr))
    for _ in range(60):
        f_l, df_l = fk(p, pl, rl, al)
        f_r, df_r = fk(p, pr, rr, ar)
        res = f_l + f_r + (ur - ul)
        p_new = p - res / (df_l + df_r)
        if p_new <= 0:
            p_new = 0.5 * p
        if abs(p_new - p) < 1.0e-12 * p:
            p = p_new
            break
        p = p_new
    ps = p
    us = 0.5 * (ul + ur) + 0.5 * (fk(ps, pr, rr, ar)[0] - fk(ps, pl, rl, al)[0])

    x = np.asarray(x, float)
    xi = np.where(t > 0, (x - setup.x0) / max(t, 1.0e-300), np.inf * np.sign(x - setup.x0))
    rho = np.empty_like(x)
    v = np.empty_like(x)
    pres = np.empty_like(x)

    gp = (g + 1.0) / (2.0 * g)
    gm = (g - 1.0) / (2.0 * g)

    for i, s in enumerate(xi):
        if s <= us:  # left of contact
            if ps > pl:  # left shock
                sl = ul - al * np.sqrt(gp * ps / pl + gm)
                if s < sl:
                    rho[i], v[i], pres[i] = rl, ul, pl
                else:
                    r = rl * ((ps / pl + (g - 1.0) / (g + 1.0))
                              / ((g - 1.0) / (g + 1.0) * ps / pl + 1.0))
                    rho[i], v[i], pres[i] = r, us, ps
            else:  # left rarefaction
                shl = ul - al
                asl = al * (ps / pl) ** ((g - 1.0) / (2.0 * g))
                stl = us - asl
                if s < shl:
                    rho[i], v[i], pres[i] = rl, ul, pl
                elif s > stl:
                    rho[i] = rl * (ps / pl) ** (1.0 / g)
                    v[i], pres[i] = us, ps
                else:  # inside fan
                    vf = 2.0 / (g + 1.0) * (al + (g - 1.0) / 2.0 * ul + s)
                    af = 2.0 / (g + 1.0) * (al + (g - 1.0) / 2.0 * (ul - s))
                    rho[i] = rl * (af / al) ** (2.0 / (g - 1.0))
                    v[i] = vf
                    pres[i] = pl * (af / al) ** (2.0 * g / (g - 1.0))
        else:  # right of contact
            if ps > pr:  # right shock
                sr = ur + ar * np.sqrt(gp * ps / pr + gm)
                if s > sr:
                    rho[i], v[i], pres[i] = rr, ur, pr
                else:
                    r = rr * ((ps / pr + (g - 1.0) / (g + 1.0))
                              / ((g - 1.0) / (g + 1.0) * ps / pr + 1.0))
                    rho[i], v[i], pres[i] = r, us, ps
            else:  # right rarefaction
                shr = ur + ar
                asr = ar * (ps / pr) ** ((g - 1.0) / (2.0 * g))
                str_ = us + asr
                if s > shr:
                    rho[i], v[i], pres[i] = rr, ur, pr
                elif s < str_:
                    rho[i] = rr * (ps / pr) ** (1.0 / g)
                    v[i], pres[i] = us, ps
                else:
                    vf = 2.0 / (g + 1.0) * (-ar + (g - 1.0) / 2.0 * ur + s)
                    af = 2.0 / (g + 1.0) * (ar - (g - 1.0) / 2.0 * (ur - s))
                    rho[i] = rr * (af / ar) ** (2.0 / (g - 1.0))
                    v[i] = vf
                    pres[i] = pr * (af / ar) ** (2.0 * g / (g - 1.0))
    return rho, v, pres


def sod_l2_density_error(state: SimState, setup: SodSetup = SodSetup(),
                         window: float = 0.4):
    """L2 density error against the exact solution over |x - x0| < window."""
    p = state.particles
    alive = p.alive.cpu().numpy()
    x = p.pos.cpu().numpy()[alive, 0]
    rho = p.rho.cpu().numpy()[alive]
    sel = np.abs(x - setup.x0) < window
    rho_exact, _, _ = sod_exact(x[sel], float(state.t), setup)
    return float(np.sqrt(np.mean((rho[sel] - rho_exact) ** 2)))


__all__ = ["SodSetup", "sod_config", "sod_ic", "sod_exact",
           "sod_l2_density_error"]
