"""Hierarchical block timesteps: power-of-two dt rungs under one base step.
Counterpart of `summersph_tpu/blockstep.py`, whose docstring gives the
scheme, its reasons and its accuracy contract.

In short (cfg.dt_bins = B > 1, a deliberate opt-in deviation from the
reference's one global dt):

* particle i steps at dt_base / 2^r on rung r = ceil(log2(dt_base /
  cand_i)) clipped to [0, B - 1], assigned once per base step from the
  candidates the global controller reduces (`ops.timestep.dt_candidates`);
* a base step is M = 2^(B-1) substeps of delta = dt_base / M.  Everyone
  drifts every substep; a particle is kicked only at its own rung's
  boundaries, with forces evaluated exactly there;
* dt_base keeps the hysteresis controller, its candidate relaxed by M.

Only the rows that close at a substep need forces.  `group_worklist`
compacts the window groups that hold such a row into a worklist, and the
gated CUDA kernels (`csrc/sph_pairs.cu`, the `_gated` entry points)
compute those groups only; the worklist and its count stay on the device,
so nothing in a substep waits for the card.  An active row reads its
inactive neighbours' positions current and their rho/P/cs/omega as of
their last close: the substep sort carries them (`sort_particles`
carry_derived).  Each substep still pays that sort, the sink layers and
the rest of the step; the pair kernels are what scales with the active
share.

The substeps are a Python loop with `j` a host integer.  The far field of
TreePM is solved at most once per base step, at its first substep (when
the base step's `pm_phase` is 0, or no valid held force exists), and held
in particles.acc_ext through the other substeps.  Sinks kick and drift
every substep at delta, and the sink lifecycle runs every substep.

A substep runs the global step's body (`integrate.py`): the same `kick`
(per-row dt and a mask), `drift`, self-gravity seam (`ops.gravity`'s
`far_field_plan` and `gas_gravity`) and end of the step
(`integrate._finish_step`).  What is the block engine's own is the rung
assignment, the gating, the masked merge of the rates and h, and the
substep loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import SimConfig
from .integrate import (_finish_step, check_supported, drift, init_carries,
                        kick)
from .ops.cuda_pairs import pair_eval
from .ops.gravity import far_field_plan, gas_gravity, sink_gravity
from .ops.sorted_grid import group_worklist, sort_h_pad, sort_particles
from .ops.timestep import dt_candidates, next_timestep
from .state import Particles, SimState
from .tracing import span, traced


def assign_rungs(p: Particles, cfg: SimConfig, dt_base) -> torch.Tensor:
    """[N] int32 rung per particle: the smallest r with dt_base / 2^r <= its
    timestep candidate, clipped to [0, dt_bins - 1].  Dead slots get rung 0
    (their candidates are +inf)."""
    cand = dt_candidates(p, cfg)
    ratio = dt_base / torch.clamp(cand, min=1.0e-30)  # inf cand -> ratio 0
    r = torch.ceil(torch.log2(torch.clamp(ratio, min=2.0 ** -40)))
    return torch.clamp(r, 0, cfg.dt_bins - 1).to(torch.int32)


def _period(rung: torch.Tensor, n_sub: int) -> torch.Tensor:
    """Substeps per step of each rung: M / 2^r."""
    return torch.bitwise_right_shift(torch.full_like(rung, n_sub), rung)


def closing_mask(rung: torch.Tensor, j: int, n_sub: int) -> torch.Tensor:
    """[N] bool: rungs whose step ends at substep boundary j + 1.  Rung r
    closes every 2^(B-1-r) substeps."""
    return ((j + 1) & (_period(rung, n_sub) - 1)) == 0


def opening_mask(rung: torch.Tensor, j: int, n_sub: int) -> torch.Tensor:
    """[N] bool: rungs whose step starts at substep boundary j."""
    return (j & (_period(rung, n_sub) - 1)) == 0


def rung_dt(rung: torch.Tensor, dt_base, dtype) -> torch.Tensor:
    """[N] per-particle step length dt_base / 2^rung."""
    return (torch.as_tensor(dt_base, dtype=dtype, device=rung.device)
            * torch.exp2(-rung.to(dtype)))


def step_binned(state: SimState, cfg: SimConfig,
                pm_phase: Optional[int] = None) -> SimState:
    """One base step = 2^(dt_bins-1) substeps of the block-timestep KDK.
    Same contract as `integrate.step`: it needs primed carried rates, and
    returns the state advanced by dt_base with the controller's next
    dt_base and the health counters' maximum over the substeps; the
    carried fields are attached first (`integrate.init_carries`).
    `pm_phase` is the base step's host-side position in the far-field
    subcycle: None or 0 solves the mesh at the first substep, nonzero
    reuses the held force after one device read of the held split
    (`run_steps` knows the held force is valid and skips the read)."""
    check_supported(cfg)
    return _step_binned(init_carries(state, cfg), cfg, pm_phase,
                        held_valid=False)


@traced("step")
def _step_binned(state: SimState, cfg: SimConfig, pm_phase: Optional[int],
                 held_valid: bool) -> SimState:
    p, s, dt_base = state.particles, state.sinks, state.dt
    dtype = p.pos.dtype
    cap0 = p.capacity
    n_sub = 1 << (cfg.dt_bins - 1)
    h_pad = sort_h_pad(cfg)
    pm_r_s = state.pm_r_s
    with span("timestep"):
        delta = dt_base / n_sub
        rung = assign_rungs(p, cfg, dt_base)
        stats_max = torch.zeros_like(state.stats)

    for j in range(n_sub):
        with span("substep"):
            # opening kick: rungs whose step starts at j, with carried rates
            p, s = kick(p, s, rung_dt(rung, dt_base, dtype),
                        opening_mask(rung, j, n_sub), delta)
            p, s = drift(p, s, delta)

            # far field: solved at most at the base step's first substep,
            # held after it (the first substep leaves a held force behind)
            plan = far_field_plan(p, cfg, (pm_phase, pm_r_s, held_valid)
                                  if j == 0 else (1, pm_r_s, True))
            # sort at the drifted positions; stale fields and the rung ride
            p2, grid, rung = sort_particles(
                p, cfg, h_pad=h_pad, carry_derived=True, extra=rung,
                min_cell=plan.min_cell)
            act = p2.alive & closing_mask(rung, j, n_sub)
            gate = group_worklist(act, cfg.window_group)

            p2d, acc_new, du, dalpha, *fused = pair_eval(
                p2, cfg, grid, plan.split, active=gate, act_mask=act)
            g = gas_gravity(p2d, cfg, plan, acc_new, *fused,
                            active_rows=act)
            if g.held is not None:
                p2d = p2d.replace(acc_ext=g.held[0])
                pm_r_s = g.held[1]
            acc_gas_sink, acc_sink = sink_gravity(p2d, s)
            s = s.replace(acc=acc_sink)

            # merge: active rows take the fresh rates, inactive keep theirs
            p2 = p2d.replace(
                acc=torch.where(act[:, None], g.acc + acc_gas_sink, p2.acc),
                du=torch.where(act, du, p2.du),
                dalpha=torch.where(act, dalpha, p2.dalpha))

            # closing kick at the rung boundary, with the fresh rates
            # (the rung was re-sorted, so each row's dt is formed anew)
            p2, s = kick(p2, s, rung_dt(rung, dt_base, dtype), act, delta)

            # the end of the step at the global engine's per-step cadence:
            # the closing rows' h-iteration and the sink lifecycle
            p, s, stats = _finish_step(p2, s, cfg, cap0, grid, g.over,
                                       active=gate, act=act)
            stats_max = torch.maximum(stats_max, stats)
            rung = rung[:cap0]

    with span("timestep"):
        dt_next = next_timestep(p, dt_base, cfg, cand_scale=float(n_sub))
        t = state.t + dt_base
    return state.replace(particles=p, sinks=s, t=t, dt=dt_next,
                         stats=stats_max, pm_r_s=pm_r_s)


__all__ = ["step_binned", "assign_rungs", "closing_mask", "opening_mask",
           "group_worklist", "rung_dt"]
