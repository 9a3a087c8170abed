"""Conserved-quantity monitors and the NaN guard.  Counterpart of
`measure`, `format_report` and `nan_guard` in
`summersph_tpu/diagnostics.py`.

The conserved sums accumulate in float64 whatever the state's dtype.  The
potential energy is a direct pair sum, O(N^2): `include_potential` is for
small states only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .state import SimState
from .utils.units import G


def measure(state: SimState,
            include_potential: bool = False) -> Dict[str, torch.Tensor]:
    p, s = state.particles, state.sinks
    pm64 = torch.where(p.alive, p.mass, 0.0).double()
    sm = torch.where(s.alive, s.mass, 0.0)
    vel = p.vel.double()
    pos = p.pos.double()

    e_kin = 0.5 * torch.sum(pm64 * torch.sum(vel * vel, dim=-1))
    e_kin = e_kin + 0.5 * torch.sum(sm * torch.sum(s.vel * s.vel, dim=-1))
    e_int = torch.sum(pm64 * torch.where(p.alive, p.u, 0.0))
    mom = (torch.sum(pm64[:, None] * vel, dim=0)
           + torch.sum(sm[:, None] * s.vel, dim=0))
    ang = (torch.sum(pm64[:, None] * torch.linalg.cross(pos, vel), dim=0)
           + torch.sum(sm[:, None] * torch.linalg.cross(s.pos, s.vel),
                       dim=0))

    out = {
        "n_gas": p.n_alive,
        "n_sinks": s.n_alive,
        "mass_gas": torch.sum(pm64),
        "mass_sinks": torch.sum(sm),
        "e_kin": e_kin,
        "e_int": e_int,
        "momentum": mom,
        "ang_momentum": ang,
        "rho_max": torch.amax(torch.where(p.alive, p.rho, 0.0)),
        "h_min": torch.amin(torch.where(p.alive, p.h, torch.inf)),
        "t": state.t,
        "dt": state.dt,
    }

    if include_potential:
        dx = pos[:, None, :] - pos[None, :, :]
        r = torch.sqrt(torch.sum(dx * dx, dim=-1))
        valid = p.alive[:, None] & p.alive[None, :] & (r > 0.0)
        inv_r = torch.where(valid, 1.0 / torch.where(valid, r, 1.0), 0.0)
        e_pot = -0.5 * G * torch.sum(pm64[:, None] * pm64[None, :] * inv_r)
        spos = s.pos.double()
        ds = torch.sqrt(torch.sum((pos[:, None, :] - spos[None, :, :]) ** 2,
                                  dim=-1))
        vs = p.alive[:, None] & s.alive[None, :] & (ds > 0.0)
        e_pot = e_pot - G * torch.sum(
            pm64[:, None] * sm.double()[None, :]
            * torch.where(vs, 1.0 / torch.where(vs, ds, 1.0), 0.0))
        out["e_pot"] = e_pot
        out["e_total"] = e_kin + e_int + e_pot
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def format_report(d: Dict) -> str:
    msg = (f"N={int(d['n_gas'])}+{int(d['n_sinks'])}s "
           f"t={float(d['t']):.6g} dt={float(d['dt']):.3e} "
           f"M={float(d['mass_gas']):.6g}+{float(d['mass_sinks']):.6g} "
           f"Ek={float(d['e_kin']):.6g} Ei={float(d['e_int']):.6g} "
           f"|p|={np.linalg.norm(_host(d['momentum'])):.3e} "
           f"|L|={np.linalg.norm(_host(d['ang_momentum'])):.6g} "
           f"rho_max={float(d['rho_max']):.3e}")
    if "e_total" in d:
        msg += f" Etot={float(d['e_total']):.6g}"
    return msg


def nan_guard(state: SimState) -> bool:
    """True if any live particle carries a non-finite pos, vel, u or rho."""
    p = state.particles
    ok = torch.ones((), dtype=torch.bool, device=p.pos.device)
    for arr in (p.pos, p.vel, p.u, p.rho):
        a = arr if arr.ndim == 1 else torch.sum(arr, dim=-1)
        ok = ok & torch.all(torch.where(p.alive, torch.isfinite(a), True))
    return not bool(ok)


__all__ = ["measure", "format_report", "nan_guard"]
