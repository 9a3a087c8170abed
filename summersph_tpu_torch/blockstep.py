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
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import SimConfig
from .integrate import _count_nonfinite, _coverage_stats, fused_split
from .ops.cuda_pairs import pair_eval
from .ops.gravity import sink_gravity
from .ops.pm_gravity import (PM_MODES, pm_long_range_held, pm_short_range,
                             recompute_far_field)
from .ops.sinks import accrete, create_sinks, cull_bounds, merge_sinks
from .ops.smoothing import update_smoothing
from .ops.sorted_grid import group_worklist, sort_h_pad, sort_particles
from .ops.timestep import dt_candidates, next_timestep
from .state import Particles, SimState, Sinks
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


@traced("kick")
def _kick_masked(p: Particles, s: Sinks, dt_p, mask, dt_sink):
    """Half-kick the masked rows by their own dt / 2 (`integrate.kick` with
    a per-particle dt and an activity mask); the sinks by dt_sink / 2,
    always."""
    m = mask & p.alive
    mm = m[:, None]
    if p.u_c is None:
        u = torch.where(m, p.u + 0.5 * dt_p * p.du, p.u)
        u_c = None
    else:
        y = 0.5 * dt_p * p.du - p.u_c
        t = p.u + y
        u_c = torch.where(m, (t - p.u) - y, p.u_c)
        u = torch.where(m, t, p.u)
    p = p.replace(
        vel=torch.where(mm, p.vel + 0.5 * dt_p[:, None] * p.acc, p.vel),
        u=u, u_c=u_c,
        alpha=torch.where(m, p.alpha + 0.5 * dt_p * p.dalpha, p.alpha))
    s = s.replace(vel=torch.where(s.alive[:, None],
                                  s.vel + 0.5 * dt_sink * s.acc, s.vel))
    return p, s


@traced("drift")
def _drift(p: Particles, s: Sinks, delta):
    p = p.replace(pos=torch.where(p.alive[:, None], p.pos + delta * p.vel,
                                  p.pos))
    s = s.replace(pos=torch.where(s.alive[:, None], s.pos + delta * s.vel,
                                  s.pos))
    return p, s


def _check_binned_cfg(cfg: SimConfig):
    if cfg.dt_bins > 10:
        # run time is linear in M = 2^(dt_bins-1), and a particle set never
        # earns 512 rungs: a dt spread that wide means dt_min or dt_max is
        # wrong
        raise ValueError(
            f"cfg.dt_bins = {cfg.dt_bins} would run "
            f"{1 << (cfg.dt_bins - 1)} substeps per base step; the "
            f"supported range is 1-10, and only 1-4 is measured")
    if cfg.neighbor_mode != "sorted":
        raise ValueError("cfg.dt_bins > 1 requires the sorted engine")
    if not cfg.reuse_forces:
        raise ValueError("cfg.dt_bins > 1 requires reuse_forces (the "
                         "carried-rate KDK is what the rung structure "
                         "interleaves)")
    if cfg.gravity == "direct":
        raise ValueError("cfg.dt_bins > 1 supports gravity in "
                         "('none', 'pm', 'bh', 'treepm')")
    if cfg.decomp == "slab":
        raise ValueError("cfg.dt_bins > 1 is single-chip (no slab decomp)")


def step_binned(state: SimState, cfg: SimConfig,
                pm_phase: Optional[int] = None) -> SimState:
    """One base step = 2^(dt_bins-1) substeps of the block-timestep KDK.
    Same contract as `integrate.step`: it needs primed carried rates, and
    returns the state advanced by dt_base with the controller's next
    dt_base and the health counters' maximum over the substeps.
    `pm_phase` is the base step's host-side position in the far-field
    subcycle: None or 0 solves the mesh at the first substep, nonzero
    reuses the held force after one device read of the held split
    (`run_steps` knows the held force is valid and skips the read)."""
    return _step_binned(state, cfg, pm_phase, held_valid=False)


@traced("step")
def _step_binned(state: SimState, cfg: SimConfig, pm_phase: Optional[int],
                 held_valid: bool) -> SimState:
    _check_binned_cfg(cfg)
    p, s, dt_base = state.particles, state.sinks, state.dt
    dtype, dev = p.pos.dtype, p.pos.device
    cap0 = p.capacity
    n_sub = 1 << (cfg.dt_bins - 1)
    pm_on = cfg.gravity in PM_MODES
    fuse = cfg.grav_fuse_short and pm_on
    h_pad = sort_h_pad(cfg)
    with span("timestep"):
        delta = dt_base / n_sub
        rung = assign_rungs(p, cfg, dt_base)
        r_s_held = (state.pm_r_s if state.pm_r_s is not None
                    else torch.zeros((), dtype=dtype, device=dev))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        stats_max = torch.zeros_like(state.stats)

    for j in range(n_sub):
        with span("substep"):
            dt_p = rung_dt(rung, dt_base, dtype)
            # opening kick: rungs whose step starts at j, with carried rates
            p, s = _kick_masked(p, s, dt_p, opening_mask(rung, j, n_sub),
                                delta)
            p, s = _drift(p, s, delta)

            # far field: solved at most at the base step's first substep, held
            # after it (the first substep leaves a valid held force behind)
            phase = (pm_phase or 0) if j == 0 else 1
            valid = held_valid if j == 0 else True
            grav_split = None
            if fuse:
                # decide here, once: the fused kernel needs the split before
                # the sort and the solve, and `pm_long_range_held` below must
                # agree without reading the held split again
                recompute = recompute_far_field(phase, r_s_held, valid)
                grav_split = fused_split(p, cfg, recompute, r_s_held)
                phase, valid = (0, valid) if recompute else (phase, True)

            # sort at the drifted positions; stale fields and the rung ride;
            # a fused step's cell is at least r_cut (`integrate.force_eval`)
            p2, grid, rung = sort_particles(
                p, cfg, h_pad=h_pad, carry_derived=True, extra=rung,
                min_cell=None if grav_split is None else grav_split[1])
            act = p2.alive & closing_mask(rung, j, n_sub)
            gate = group_worklist(act, cfg.window_group)

            out = pair_eval(p2, cfg, grid, grav_split, active=gate,
                            act_mask=act)
            p2d, acc_new, du, dalpha = out[:4]

            grav_over = zero
            if pm_on:
                acc_long, r_s_held = pm_long_range_held(p2d, cfg, phase,
                                                        r_s_held, valid)
                p2d = p2d.replace(acc_ext=acc_long)
                if fuse:
                    acc_new = acc_new + acc_long + out[4]
                else:
                    acc_short, grav_over = pm_short_range(p2d, cfg, r_s_held,
                                                          active_rows=act)
                    acc_new = acc_new + acc_long + acc_short

            acc_gas_sink, acc_sink = sink_gravity(p2d, s)
            acc_new = acc_new + acc_gas_sink
            s = s.replace(acc=acc_sink)

            # merge: active rows take the fresh rates, inactive keep theirs
            p2 = p2d.replace(acc=torch.where(act[:, None], acc_new, p2.acc),
                             du=torch.where(act, du, p2.du),
                             dalpha=torch.where(act, dalpha, p2.dalpha))

            # closing kick at the rung boundary, with the fresh rates
            # (the rung was re-sorted, so each row's dt is formed anew)
            p2, s = _kick_masked(p2, s, rung_dt(rung, dt_base, dtype), act,
                                 delta)

            # per-substep epilogue, at the global engine's per-step cadence:
            # the h-iteration of the closing rows and the sink lifecycle
            n_unconverged = sink_full = zero
            if cfg.fixed_h is None:
                p_h, n_unconverged = update_smoothing(
                    p2, cfg, grid=grid, active=gate, act_mask=act)
                # only h moves; rho/P/cs/omega keep the stale-consistent merge
                p2 = p2.replace(h=torch.where(act, p_h.h, p2.h))
                s, sink_full = create_sinks(p2, s, cfg)

            p2, s = accrete(p2, s)
            if cfg.sink_merge_factor > 0.0:
                s, _ = merge_sinks(s, cfg)
            p2, s = cull_bounds(p2, s, cfg)

            with span("stats"):
                stats_max = torch.maximum(stats_max, _coverage_stats(
                    cfg, grid, grav_over, n_unconverged,
                    _count_nonfinite(p2), sink_full))

            if p2.capacity != cap0:  # drop the sort's dead pad slots
                p2 = p2.map(lambda a: a[:cap0])
                rung = rung[:cap0]
            p = p2

    with span("timestep"):
        dt_next = next_timestep(p, dt_base, cfg, cand_scale=float(n_sub))
        t = state.t + dt_base
    out = state.replace(particles=p, sinks=s, t=t, dt=dt_next,
                        stats=stats_max)
    if state.pm_r_s is not None:
        out = out.replace(pm_r_s=r_s_held if pm_on else state.pm_r_s)
    return out


__all__ = ["step_binned", "assign_rungs", "closing_mask", "opening_mask",
           "group_worklist", "rung_dt"]
