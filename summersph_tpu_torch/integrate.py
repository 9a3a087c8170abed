"""KDK leapfrog on the sorted, single-device path, with fixed or variable
(grad-h) smoothing length, sink gravity, optional gas self-gravity (direct,
or TreePM with the fused or separate short range and the held far field),
and sink creation and merging.

Counterpart of `summersph_tpu/integrate.py`.  One step:

    kick(dt/2) ; drift(dt)
    sort -> density kernel -> EOS -> force kernel   (ops.cuda_pairs)
    [self-gravity: PM mesh + short-range kernel, or the fused force kernel]
    sink gravity ; kick(dt/2)
    t += dt ; dt hysteresis update
    [variable h: h-iteration on the step's sort ; sink creation]
    sink accretion ; [sink merging] ; bounds cull ; health counters

With `cfg.dt_bins > 1` `run_steps` advances by base steps of the
block-timestep engine instead (`blockstep.py`).

With `cfg.reuse_forces` (the default) the rates of the previous step's
evaluation feed the first half-kick, so a step evaluates forces once and
`prime` evaluates them before the first step; False is the reference's
literal two-evaluation schedule.

PyTorch runs eagerly, so `run_steps` is a Python loop.  `t`, `dt`, the
held PM split and the health counters stay on the device; nothing in a
step waits for the card.  The far-field phase of `cfg.pm_every` is a host
integer (`run_steps` passes step % pm_every, phase 0 first).
`run_until` advances in segments of `run_steps` with one host read of `t`
between them, and `simulate` is the user's run loop: `cfg.n_saves` evenly
spaced `saveN.txt` snapshots up to `cfg.end_time`, a diagnostics line per
tick and the health checks.

`neighbor_mode='grid'` runs on the sorted engine: the JAX package's hashed
grid exists because gathers are dear on the TPU, and both engines sum the
same pairs.  Configurations outside the ported path raise
`NotImplementedError` (`check_supported`).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Optional

import torch

from .config import SimConfig
from .ops.cuda_pairs import pair_eval, window_overflow
from .ops.gravity import gas_gravity_direct, sink_gravity
from .ops.pm_gravity import (PM_MODES, gas_gravity_pm, gas_gravity_pm_held,
                             pm_geometry, pm_long_range_held,
                             recompute_far_field)
from .ops.sinks import accrete, create_sinks, cull_bounds, merge_sinks
from .ops.smoothing import update_smoothing
from .ops.sorted_grid import SORTED_MODES, sort_particles
from .ops.timestep import next_timestep
from .state import Particles, SimState, Sinks


def check_supported(cfg: SimConfig, axis_name: Optional[str] = None):
    """Raise NotImplementedError for a configuration the port does not run
    yet (ROADMAP.md lists the later slices)."""
    problems = []
    if cfg.neighbor_mode not in SORTED_MODES:
        problems.append(f"neighbor_mode={cfg.neighbor_mode!r} "
                        f"(only 'sorted' and 'grid')")
    if axis_name is not None:
        problems.append(f"multi-device runs (axis_name={axis_name!r})")
    if problems:
        raise NotImplementedError(
            "not ported to summersph_tpu_torch yet: " + "; ".join(problems))


def force_eval(p: Particles, s: Sinks, cfg: SimConfig,
               axis_name: Optional[str] = None, pm=None):
    """Sort -> density -> EOS -> SPH forces -> self-gravity -> sink gravity.

    Returns (particles with rho/P/cs/omega/acc/du/dalpha filled, sinks with
    acc, aux = (grid, grav_overflow, pm_r_s)).  grav_overflow is 0 except
    on a fused step whose r_cut exceeds the SPH cell; pm_r_s is the split
    the (possibly held) far field was built with when cfg.pm_every > 1,
    else None.  `pm` = (pm_phase, r_s_held, held_valid) drives the
    far-field subcycle (`pm_gravity.recompute_far_field`); None recomputes.
    The returned particles are in sorted order and may be padded beyond
    the caller's capacity; `step` and `prime` slice back.
    """
    if cfg.pm_every > 1 and (cfg.neighbor_mode != "sorted"
                             or (axis_name is not None
                                 and cfg.decomp == "slab")):
        raise ValueError(
            "cfg.pm_every > 1 (held long-range PM force) is implemented "
            "for neighbor_mode='sorted' without slab decomposition")
    if cfg.grav_fuse_short and (cfg.neighbor_mode != "sorted"
                                or not cfg.use_pallas
                                or axis_name is not None):
        raise ValueError(
            "cfg.grav_fuse_short (short-range gravity fused into the SPH "
            "force kernel) is implemented for the single-device sorted "
            "engine with use_pallas=True")
    check_supported(cfg, axis_name)
    return _force_eval_sorted(p, s, cfg, pm)


def _force_eval_sorted(p: Particles, s: Sinks, cfg: SimConfig, pm=None):
    """force_eval on the sorted window engine.  Self-gravity takes one of
    four branches: direct; TreePM with the short range fused into the
    force kernel; TreePM with the separate short-range kernel; either
    TreePM form with the far field held between solves (cfg.pm_every).
    With variable h the sort carries `cfg.sort_h_pad` cell headroom, so
    the same grid stays exact through the step's h-iteration."""
    h_pad = 1.0 if cfg.fixed_h is not None else cfg.sort_h_pad
    p2, sgrid = sort_particles(p, cfg, h_pad=h_pad)
    pm_grav = cfg.gravity in PM_MODES
    fuse = cfg.grav_fuse_short and pm_grav
    phase = r_s_held = None
    held_valid = False
    if pm_grav and cfg.pm_every > 1 and pm is not None:
        phase, r_s_held, held_valid = pm

    # The fused force kernel needs the split before the long-range solve:
    # pm_geometry gives the value the solve will use; on a held step the
    # complement must match the held split instead.
    grav_split = None
    if fuse:
        if recompute_far_field(phase, r_s_held, held_valid):
            r_s_use = pm_geometry(p2, cfg)[2]
        else:
            r_s_use = r_s_held.to(p2.pos.dtype)
        grav_split = (r_s_use, cfg.effective_rcut_rs() * r_s_use)

    out = pair_eval(p2, cfg, sgrid, grav_split)
    p2, acc, du, dalpha = out[:4]

    grav_over = torch.zeros((), dtype=torch.int32, device=p2.pos.device)
    pm_r_s = None
    if cfg.gravity == "direct":
        acc = acc + gas_gravity_direct(p2, cfg)
    elif fuse:
        acc_long, r_s_out = pm_long_range_held(p2, cfg, phase, r_s_held,
                                               held_valid)
        if cfg.pm_every > 1:
            p2 = p2.replace(acc_ext=acc_long)
            pm_r_s = r_s_out
        acc = acc + acc_long + out[4]
        # the fused sums ride the SPH windows, which bound every gravity
        # pair only while r_cut <= the sort cell; a step that breaks this
        # reports every live row, loud, never silent
        grav_over = torch.where(grav_split[1] <= sgrid.cell_size, 0,
                                torch.sum(p2.alive)).to(torch.int32)
    elif pm_grav:
        if cfg.pm_every > 1:
            acc_pm, grav_over, acc_long, pm_r_s = gas_gravity_pm_held(
                p2, cfg, phase, r_s_held, held_valid)
            p2 = p2.replace(acc_ext=acc_long)
        else:
            acc_pm, grav_over = gas_gravity_pm(p2, cfg)
        acc = acc + acc_pm

    acc_gas_sink, acc_sink = sink_gravity(p2, s)
    p2 = p2.replace(acc=acc + acc_gas_sink, du=du, dalpha=dalpha)
    return p2, s.replace(acc=acc_sink), (sgrid, grav_over, pm_r_s)


def kick(p: Particles, s: Sinks, dt):
    """Half-kick: v += a dt/2, u += du dt/2, alpha += dalpha dt/2, with
    the Kahan-compensated u update when the carry `u_c` is present."""
    am = p.alive[:, None]
    al = p.alive
    if p.u_c is None:
        u = torch.where(al, p.u + 0.5 * dt * p.du, p.u)
        u_c = None
    else:
        y = 0.5 * dt * p.du - p.u_c
        t = p.u + y
        u_c = torch.where(al, (t - p.u) - y, p.u_c)
        u = torch.where(al, t, p.u)
    p = p.replace(
        vel=torch.where(am, p.vel + 0.5 * dt * p.acc, p.vel),
        u=u, u_c=u_c,
        alpha=torch.where(al, p.alpha + 0.5 * dt * p.dalpha, p.alpha))
    s = s.replace(vel=torch.where(s.alive[:, None],
                                  s.vel + 0.5 * dt * s.acc, s.vel))
    return p, s


def drift(p: Particles, s: Sinks, dt):
    """Full drift: x += v dt."""
    p = p.replace(pos=torch.where(p.alive[:, None], p.pos + dt * p.vel,
                                  p.pos))
    s = s.replace(pos=torch.where(s.alive[:, None], s.pos + dt * s.vel,
                                  s.pos))
    return p, s


def _coverage_stats(cfg: SimConfig, grid, grav_over, n_unconverged,
                    nonfinite, sink_full):
    """int32[len(STATS_FIELDS)] health counters for this step.  The
    decomposition slot stays 0: multi-device runs are not ported."""
    zero = torch.zeros((), dtype=torch.int32, device=grid.key.device)
    return torch.stack([window_overflow(grid, cfg), grid.n_clamped,
                        grav_over.to(torch.int32),
                        n_unconverged.to(torch.int32),
                        nonfinite.to(torch.int32), sink_full.to(torch.int32),
                        zero])


def _count_nonfinite(p: Particles) -> torch.Tensor:
    """Live particles whose u, pos or vel went non-finite this step."""
    ok = (torch.isfinite(p.u) & torch.all(torch.isfinite(p.pos), dim=-1)
          & torch.all(torch.isfinite(p.vel), dim=-1))
    return torch.sum(p.alive & ~ok).to(torch.int32)


def step(state: SimState, cfg: SimConfig, axis_name: Optional[str] = None,
         pm_phase: Optional[int] = None) -> SimState:
    """One full KDK step.  With `cfg.reuse_forces` it needs primed rates
    (see `prime`).  `pm_phase` (cfg.pm_every > 1): this step's host-side
    position in the far-field subcycle -- None or 0 solves the mesh,
    nonzero reuses the held force, after one device read of the held
    split (`run_steps` knows the held force is valid and skips it)."""
    return _step(state, cfg, axis_name, pm_phase, held_valid=False)


def _step(state: SimState, cfg: SimConfig, axis_name: Optional[str],
          pm_phase: Optional[int], held_valid: bool) -> SimState:
    check_supported(cfg, axis_name)
    p, s, dt = state.particles, state.sinks, state.dt
    cap0 = p.capacity
    pm = None
    if cfg.pm_every > 1 and pm_phase is not None \
            and state.pm_r_s is not None:
        pm = (pm_phase, state.pm_r_s, held_valid)

    if cfg.reuse_forces:
        p, s = kick(p, s, dt)
        p, s = drift(p, s, dt)
        p, s, (grid, grav_over, pm_r_s) = force_eval(p, s, cfg, axis_name,
                                                     pm=pm)
        p, s = kick(p, s, dt)
    else:
        p, s, _ = force_eval(p, s, cfg, axis_name, pm=pm)
        p, s = kick(p, s, dt)
        p, s = drift(p, s, dt)
        p, s, (grid, grav_over, pm_r_s) = force_eval(p, s, cfg, axis_name,
                                                     pm=pm)
        p, s = kick(p, s, dt)

    t = state.t + dt
    dt = next_timestep(p, dt, cfg)

    n_unconverged = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    sink_full = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    if cfg.fixed_h is None:
        p, n_unconverged = update_smoothing(p, cfg, grid=grid)
        s, sink_full = create_sinks(p, s, cfg)

    p, s = accrete(p, s)
    if cfg.sink_merge_factor > 0.0:
        s, _ = merge_sinks(s, cfg)
    p, s = cull_bounds(p, s, cfg)

    stats = _coverage_stats(cfg, grid, grav_over, n_unconverged,
                            _count_nonfinite(p), sink_full)
    if p.capacity != cap0:  # drop the sort's dead pad slots
        p = p.map(lambda a: a[:cap0])
    out = state.replace(particles=p, sinks=s, t=t, dt=dt, stats=stats)
    if pm_r_s is not None:  # carry the held PM split (cfg.pm_every)
        out = out.replace(pm_r_s=pm_r_s)
    return out


def init_carries(state: SimState, cfg: SimConfig) -> SimState:
    """Attach or drop the optional carried fields so the state matches the
    config: the Kahan carry u_c (cfg.kahan_u) and the held PM force acc_ext
    with its split pm_r_s (cfg.pm_every > 1 or dt_bins > 1 with PM
    gravity; pm_r_s starts at 0, "no valid held force", so the first step
    solves).  Idempotent."""
    p = state.particles
    if cfg.kahan_u and p.u_c is None:
        p = p.replace(u_c=torch.zeros_like(p.u))
    if not cfg.kahan_u and p.u_c is not None:
        p = p.replace(u_c=None)
    pm_on = ((cfg.pm_every > 1 or cfg.dt_bins > 1)
             and cfg.gravity in PM_MODES)
    pm_r_s = state.pm_r_s
    if pm_on and p.acc_ext is None:
        p = p.replace(acc_ext=torch.zeros_like(p.pos))
    if pm_on and pm_r_s is None:
        pm_r_s = torch.zeros((), dtype=p.pos.dtype, device=p.pos.device)
    if not pm_on:
        p, pm_r_s = p.replace(acc_ext=None), None
    return state.replace(particles=p, pm_r_s=pm_r_s)


# The name the JAX package keeps for code written before the PM carries.
init_kahan = init_carries


def prime(state: SimState, cfg: SimConfig) -> SimState:
    """Evaluate forces at the current positions (acc/du/dalpha and
    rho/P/cs/omega, and with cfg.pm_every > 1 a fresh acc_ext), as the
    carried-rate KDK needs before its first step.  The particle order
    comes back permuted (identity in pid)."""
    state = init_carries(state, cfg)
    cap0 = state.particles.capacity
    p, s, _ = force_eval(state.particles, state.sinks, cfg)
    if p.capacity != cap0:
        p = p.map(lambda a: a[:cap0])
    return state.replace(particles=p, sinks=s)


def run_steps(state: SimState, cfg: SimConfig, n_steps: int) -> SimState:
    """Advance exactly n_steps: global steps, or with cfg.dt_bins > 1 base
    steps of the block-timestep engine (`blockstep.step_binned`).  The
    far-field phase is step % pm_every, pinned to this call: its first step
    solves the mesh, so a resumed state never starts from a stale held
    force, and the later steps know their held force is valid.  The
    returned `stats` is the running maximum of the per-step counters over
    these steps, so one bad step cannot hide."""
    from .blockstep import _step_binned  # blockstep imports this module

    state = init_carries(state, cfg)
    state = state.replace(stats=torch.zeros_like(state.stats))
    every = max(cfg.pm_every, 1)
    for i in range(n_steps):
        if cfg.dt_bins > 1:
            out = _step_binned(state, cfg, i % every, held_valid=i > 0)
        else:
            out = _step(state, cfg, None, i % every, held_valid=i > 0)
        state = out.replace(stats=torch.maximum(out.stats, state.stats))
    return state


def check_coverage(state: SimState, cfg: SimConfig, warn: bool = True) -> int:
    """Neighbour candidates the pair passes would drop for the current
    particle distribution (`cuda_pairs.window_overflow`).  The kernels and
    their plain versions walk every window group's whole candidate range,
    so this is 0 and `warn` has nothing to warn about; the JAX package's
    static windows can drop pairs, and its signature is kept."""
    h_pad = 1.0 if cfg.fixed_h is not None else cfg.sort_h_pad
    _, grid = sort_particles(state.particles, cfg, h_pad=h_pad)
    return int(window_overflow(grid, cfg))


def warn_stats(state: SimState, tick: Optional[int] = None) -> bool:
    """Print a loud warning if the step's health counters are nonzero;
    returns True when anything tripped (`h_unconverged` is informational)."""
    d = state.stats_dict()
    bad = {k: v for k, v in d.items() if v and k != "h_unconverged"}
    if bad:
        where = f" at tick {tick}" if tick is not None else ""
        print(f"WARNING{where}: step health counters tripped: {bad} — "
              f"nonfinite means failing physics (see check_health)",
              flush=True)
    return bool(bad)


class SimulationDiverged(RuntimeError):
    """Raised by check_health when the state can no longer advance."""


def check_health(state: SimState, where: str = "") -> None:
    """Raise SimulationDiverged on a non-finite live particle, an all-dead
    state, or a non-finite clock."""
    d = state.stats_dict()
    n_alive = int(state.particles.n_alive)
    t, dt = float(state.t), float(state.dt)
    problems = []
    if d.get("nonfinite"):
        problems.append(f"{d['nonfinite']} live particles have non-finite "
                        f"u/pos/vel")
    if n_alive == 0:
        problems.append("every gas particle is dead (culled or accreted)")
    if not (math.isfinite(t) and math.isfinite(dt)):
        problems.append(f"non-finite clock: t={t} dt={dt}")
    if problems:
        raise SimulationDiverged(
            f"simulation diverged{' ' + where if where else ''} "
            f"(t={t:.6g}, dt={dt:.3g}, N={n_alive}): " + "; ".join(problems))


def run_until(state: SimState, t_stop, cfg: SimConfig,
              max_steps: int = 1_000_000, steps_per_sync: int = 8) -> SimState:
    """Advance until t >= t_stop, in `run_steps` segments of
    `steps_per_sync` steps with one host read of `t` between them.  It may
    overshoot t_stop by up to steps_per_sync - 1 steps, as the JAX
    package's `run_until` does."""
    t_stop = float(t_stop)
    done = 0
    while float(state.t) < t_stop and done < max_steps:
        state = run_steps(state, cfg, steps_per_sync)
        done += steps_per_sync
    return state


def simulate(
    state: SimState,
    cfg: SimConfig,
    out_dir: Optional[str] = None,
    snapshot_columns: int = 9,
    on_tick: Optional[Callable[[int, SimState], None]] = None,
    verbose: bool = True,
) -> SimState:
    """Run to cfg.end_time with cfg.n_saves evenly spaced ticks.  At each
    tick: a diagnostics line, `warn_stats`, the `saveN.txt` snapshot in
    `out_dir`, `on_tick`, then `check_health`.  Every saveN index is
    written: ticks that one segment passes get the same state."""
    from .diagnostics import format_report, measure
    from .io.txt import save_path, write_snapshot_txt

    check_coverage(state, cfg, warn=True)
    if cfg.reuse_forces:
        state = prime(state, cfg)
    ticks = [cfg.end_time * (i + 1) / cfg.n_saves for i in range(cfg.n_saves)]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    for i, t_tick in enumerate(ticks):
        t0 = time.time()
        if float(state.t) < t_tick:
            state = run_until(state, t_tick, cfg)
        if verbose:
            print(f"[tick {i}] {format_report(measure(state))} "
                  f"wall: {time.time() - t0:.2f}s", flush=True)
        warn_stats(state, tick=i)
        if out_dir:
            write_snapshot_txt(save_path(out_dir, i), state.particles,
                               state.sinks, columns=snapshot_columns)
        if on_tick is not None:
            on_tick(i, state)
        check_health(state, where=f"at tick {i}")
    return state


__all__ = ["check_supported", "force_eval", "kick", "drift", "step",
           "init_carries", "init_kahan", "prime", "run_steps", "run_until",
           "simulate", "check_coverage", "warn_stats", "check_health",
           "SimulationDiverged"]
