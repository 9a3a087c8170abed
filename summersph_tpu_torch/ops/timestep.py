"""Adaptive global timestep with hysteresis.  Counterpart of
`summersph_tpu/ops/timestep.py`, whose docstring gives the four criteria
and the collapse guard (`cfg.dt_bound_candidate`).

`dt` stays a 0-d tensor on the device: nothing here waits for the card.
On several devices the candidate's minimum is taken over the ranks.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..parallel.comm import pmin
from ..state import Particles


def _safe_ratio(num, den):
    ok = den > 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), torch.inf)


def dt_candidates(p: Particles, cfg: SimConfig) -> torch.Tensor:
    """[N] per-particle dt candidates (the four criteria, scaled by
    timestep_scale); +inf on dead particles."""
    v2 = torch.sum(p.vel * p.vel, dim=-1)
    a2 = torch.sum(p.acc * p.acc, dim=-1)
    t_acc = torch.sqrt(_safe_ratio(v2, a2))
    t_u = _safe_ratio(p.u, torch.abs(p.du))
    t_h = _safe_ratio(p.h, torch.sqrt(v2))
    t_cfl = _safe_ratio(p.h, 2.2 * p.cs)
    cand = torch.minimum(torch.minimum(t_acc, t_u),
                         torch.minimum(t_h, t_cfl))
    return torch.where(p.alive, cand, torch.inf) * cfg.timestep_scale


def next_timestep(p: Particles, dt: torch.Tensor, cfg: SimConfig,
                  axis_name=None, cand_scale: float = 1.0) -> torch.Tensor:
    """Grow x dt_grow when the candidate exceeds 2 dt (capped at dt_max),
    shrink x dt_shrink when below dt / 2 (floored at dt_min), then bound
    by the candidate itself unless cfg.dt_bound_candidate is off.
    `cand_scale` relaxes the candidate: with block timesteps the base step
    may exceed the tightest particle's candidate by 2^(dt_bins - 1),
    because that particle steps on the deepest rung (blockstep.py).
    With `axis_name` (a `parallel.Mesh`) `p` is a rank's rows and the
    minimum is global."""
    cand = dt_candidates(p, cfg) / cfg.timestep_scale
    cand_min = torch.amin(cand)
    if axis_name is not None:
        cand_min = pmin(cand_min, axis_name)
    dt_cand = cand_min * cfg.timestep_scale * cand_scale
    grown = torch.where((dt_cand > 2.0 * dt) & (cfg.dt_grow * dt < cfg.dt_max),
                        cfg.dt_grow * dt, dt)
    shrunk = torch.where(
        (dt_cand < cfg.dt_shrink * dt) & (dt * cfg.dt_shrink > cfg.dt_min),
        cfg.dt_shrink * dt, grown)
    if not cfg.dt_bound_candidate:
        return shrunk
    return torch.clamp(torch.minimum(shrunk, dt_cand), min=cfg.dt_min)


__all__ = ["next_timestep", "dt_candidates"]
