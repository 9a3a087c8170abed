"""Initial conditions from the seed, on the device, in a few large calls.

A (rotating) ball of gas, flattened by `aspect`, with a central sink:
the geometry of the program's `models.disc.disc_ic` (a uniform ball by
rejection, Keplerian, rigid, rigid-body or no rotation about z), drawn
with a `torch.Generator` on the card in float64.  The configuration's
`ic` block gives the parameters, `n` the particle count; every seed gives
the same sizes.  Where the block names a `geometry_seed`, the ball is
drawn from that seed in every run and the run's seed orders its
particles: the same set in another order.  The program gets the arrays
through its own constructors (`Particles.create`, `Sinks.create`,
`SimState.create`).
"""

from __future__ import annotations

import torch

G = 39.47841760435743


def sample(ic: dict, n: int, seed: int, device) -> dict:
    """float64 arrays of the particles and the central sink."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ic.get("geometry_seed", seed)) & 0xFFFF_FFFF_FFFF_FFFF)
    r_max = float(ic["r_max"])
    f64 = torch.float64
    got, have = [], 0
    while have < n:
        cand = 2.0 * r_max * (torch.rand((2 * n, 3), generator=gen,
                                         dtype=f64, device=device) - 0.5)
        cand = cand[torch.sum(cand * cand, dim=1) <= r_max * r_max]
        got.append(cand)
        have += cand.shape[0]
    pos = torch.cat(got)[:n]
    if "geometry_seed" in ic:
        order = torch.Generator(device=device)
        order.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
        pos = pos[torch.randperm(n, generator=order, device=device)]
    pos[:, 2] *= float(ic["aspect"])
    r_cyl = torch.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    r_safe = torch.clamp(r_cyl, min=1.0e-8 * r_max)
    m_star = float(ic["m_star"])
    rot = ic["rotation"]
    if rot == "keplerian":
        vmag = torch.sqrt(G * max(m_star, 1.0e-30) / r_safe)
    elif rot == "rigid":
        vmag = torch.full_like(r_cyl, float(ic["v_circ"]))
    elif rot == "rigidbody":
        vmag = float(ic["v_circ"]) * r_cyl / r_max
    elif rot == "none":
        vmag = torch.zeros_like(r_cyl)
    else:
        raise ValueError(f"unknown rotation {rot!r}")
    vel = torch.stack([-vmag * pos[:, 1] / r_safe, vmag * pos[:, 0] / r_safe,
                       torch.zeros_like(r_cyl)], dim=1)
    return {"pos": pos, "vel": vel,
            "mass": torch.full((n,), float(ic["m_disc"]) / n, dtype=f64,
                               device=device),
            "u": float(ic["u0"]), "alpha": float(ic["alpha0"]),
            "h": float(ic["h0"]), "m_star": max(m_star, 0.0),
            "sink_radius": float(ic["sink_radius"]) if m_star > 0 else 0.0}


def program_state(prog, cfg, ic: dict, n: int, seed: int, device):
    """The program's SimState at t = 0 from `sample`."""
    a = sample(ic, n, seed, device)
    dtype = cfg.np_dtype()
    p = prog.Particles.create(pos=a["pos"], vel=a["vel"], mass=a["mass"],
                              u=a["u"], alpha=a["alpha"], h=a["h"],
                              capacity=n, dtype=dtype, device=device)
    z = torch.zeros((1, 3), dtype=torch.float64, device=device)
    s = prog.Sinks.create(pos=z, vel=z, mass=[a["m_star"]],
                          radius=[a["sink_radius"]],
                          capacity=cfg.sink_capacity, dtype=dtype,
                          device=device)
    return prog.SimState.create(p, s, dt=cfg.dt_init)


__all__ = ["sample", "program_state"]
