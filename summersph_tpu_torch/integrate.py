"""KDK leapfrog on the sorted, single-device, fixed-h, gravity='none' path.

Counterpart of `summersph_tpu/integrate.py`.  One step:

    kick(dt/2) ; drift(dt)
    sort -> density kernel -> EOS -> force kernel   (ops.cuda_pairs)
    sink gravity ; kick(dt/2)
    t += dt ; dt hysteresis update
    sink accretion ; bounds cull ; health counters

With `cfg.reuse_forces` (the default) the rates of the previous step's
evaluation feed the first half-kick, so a step evaluates forces once and
`prime` evaluates them before the first step; False is the reference's
literal two-evaluation schedule.

PyTorch runs eagerly, so `run_steps` is a Python loop.  `t`, `dt` and the
health counters stay on the device; nothing in a step waits for the card.
Configurations outside the ported path raise `NotImplementedError`
(`check_supported`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .config import SimConfig
from .ops.cuda_pairs import pair_eval, window_overflow
from .ops.gravity import sink_gravity
from .ops.sinks import accrete, cull_bounds
from .ops.sorted_grid import sort_particles
from .ops.timestep import next_timestep
from .state import Particles, SimState, Sinks


def check_supported(cfg: SimConfig, axis_name: Optional[str] = None):
    """Raise NotImplementedError for a configuration the port does not run
    yet (ROADMAP.md lists the later slices)."""
    problems = []
    if cfg.gravity != "none":
        problems.append(f"gravity={cfg.gravity!r} (only 'none')")
    if cfg.fixed_h is None:
        problems.append("variable h (fixed_h=None)")
    if cfg.dt_bins > 1:
        problems.append(f"block timesteps (dt_bins={cfg.dt_bins})")
    if cfg.pm_every > 1:
        problems.append(f"held PM force (pm_every={cfg.pm_every})")
    if cfg.grav_fuse_short:
        problems.append("grav_fuse_short")
    if cfg.neighbor_mode != "sorted":
        problems.append(f"neighbor_mode={cfg.neighbor_mode!r} "
                        f"(only 'sorted')")
    if cfg.sink_merge_factor > 0.0:
        problems.append("sink merging (sink_merge_factor > 0)")
    if axis_name is not None:
        problems.append(f"multi-device runs (axis_name={axis_name!r})")
    if problems:
        raise NotImplementedError(
            "not ported to summersph_tpu_torch yet: " + "; ".join(problems))


def force_eval(p: Particles, s: Sinks, cfg: SimConfig,
               axis_name: Optional[str] = None):
    """Sort -> density -> EOS -> SPH forces -> sink gravity.

    Returns (particles with rho/P/cs/omega/acc/du/dalpha filled, sinks with
    acc, aux = (grid, grav_overflow)); grav_overflow is 0 without gravity.
    The returned particles are in sorted order and may be padded beyond the
    caller's capacity; `step` and `prime` slice back.
    """
    check_supported(cfg, axis_name)
    p2, grid = sort_particles(p, cfg, h_pad=1.0)
    p2, acc, du, dalpha = pair_eval(p2, cfg, grid)
    acc_gas_sink, acc_sink = sink_gravity(p2, s)
    p2 = p2.replace(acc=acc + acc_gas_sink, du=du, dalpha=dalpha)
    grav_over = torch.zeros((), dtype=torch.int32, device=p2.pos.device)
    return p2, s.replace(acc=acc_sink), (grid, grav_over)


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


def _coverage_stats(cfg: SimConfig, grid, grav_over, nonfinite):
    """int32[len(STATS_FIELDS)] health counters for this step.  The
    h-iteration, sink-creation and decomposition slots stay 0: variable h,
    sink creation and multi-device runs are not ported."""
    zero = torch.zeros((), dtype=torch.int32, device=grid.key.device)
    return torch.stack([window_overflow(grid, cfg), grid.n_clamped,
                        grav_over.to(torch.int32), zero,
                        nonfinite.to(torch.int32), zero, zero])


def _count_nonfinite(p: Particles) -> torch.Tensor:
    """Live particles whose u, pos or vel went non-finite this step."""
    ok = (torch.isfinite(p.u) & torch.all(torch.isfinite(p.pos), dim=-1)
          & torch.all(torch.isfinite(p.vel), dim=-1))
    return torch.sum(p.alive & ~ok).to(torch.int32)


def step(state: SimState, cfg: SimConfig,
         axis_name: Optional[str] = None) -> SimState:
    """One full KDK step.  With `cfg.reuse_forces` it needs primed rates
    (see `prime`)."""
    check_supported(cfg, axis_name)
    p, s, dt = state.particles, state.sinks, state.dt
    cap0 = p.capacity

    if cfg.reuse_forces:
        p, s = kick(p, s, dt)
        p, s = drift(p, s, dt)
        p, s, (grid, grav_over) = force_eval(p, s, cfg)
        p, s = kick(p, s, dt)
    else:
        p, s, _ = force_eval(p, s, cfg)
        p, s = kick(p, s, dt)
        p, s = drift(p, s, dt)
        p, s, (grid, grav_over) = force_eval(p, s, cfg)
        p, s = kick(p, s, dt)

    t = state.t + dt
    dt = next_timestep(p, dt, cfg)

    p, s = accrete(p, s)
    p, s = cull_bounds(p, s, cfg)

    stats = _coverage_stats(cfg, grid, grav_over, _count_nonfinite(p))
    if p.capacity != cap0:  # drop the sort's dead pad slots
        p = p.map(lambda a: a[:cap0])
    return state.replace(particles=p, sinks=s, t=t, dt=dt, stats=stats)


def init_carries(state: SimState, cfg: SimConfig) -> SimState:
    """Attach or drop the Kahan carry u_c so the state matches
    cfg.kahan_u, and drop the held-PM carries (acc_ext, pm_r_s), which
    only PM gravity uses.  Idempotent."""
    p = state.particles
    if cfg.kahan_u and p.u_c is None:
        p = p.replace(u_c=torch.zeros_like(p.u))
    if not cfg.kahan_u and p.u_c is not None:
        p = p.replace(u_c=None)
    return state.replace(particles=p.replace(acc_ext=None), pm_r_s=None)


def prime(state: SimState, cfg: SimConfig) -> SimState:
    """Evaluate forces at the current positions (acc/du/dalpha and
    rho/P/cs/omega), as the carried-rate KDK needs before its first step.
    The particle order comes back permuted (identity in pid)."""
    state = init_carries(state, cfg)
    cap0 = state.particles.capacity
    p, s, _ = force_eval(state.particles, state.sinks, cfg)
    if p.capacity != cap0:
        p = p.map(lambda a: a[:cap0])
    return state.replace(particles=p, sinks=s)


def run_steps(state: SimState, cfg: SimConfig, n_steps: int) -> SimState:
    """Advance exactly n_steps.  The returned `stats` is the running
    maximum of the per-step counters over these steps, so one bad step
    cannot hide."""
    state = init_carries(state, cfg)
    state = state.replace(stats=torch.zeros_like(state.stats))
    for _ in range(n_steps):
        out = step(state, cfg)
        state = out.replace(stats=torch.maximum(out.stats, state.stats))
    return state


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


__all__ = ["check_supported", "force_eval", "kick", "drift", "step",
           "init_carries", "prime", "run_steps", "warn_stats",
           "check_health", "SimulationDiverged"]
