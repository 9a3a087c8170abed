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
block-timestep engine instead (`blockstep.py`), on one device only: on a
mesh it runs the global step, as the JAX package's sharded steps do.

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
same pairs.  `neighbor_mode='dense'` runs the O(N^2) oracle
(`ops/density.py`, `ops/forces.py`): every pair, no sort.

With `axis_name` (a `parallel.Mesh`; `parallel/sharded.py` drives it) the
same step runs on several ranks in gather mode: each holds a slab of the
particle rows and the replicated sinks, t and dt.  The sorted engine
gathers the particles, sorts the whole set on every rank and sums the
rank's slab of the sorted rows (`_force_eval_sorted_sharded`, the
row-slab kernels); the dense engine sums the rank's rows against the
gathered columns; dt, accretion, sink creation and the sink pull go
through the mesh's collectives, and of the health counters the
h-iteration's and the non-finite count are summed over the ranks (the
window counters come from the replicated sort).

With `cfg.decomp='slab'` the sorted engine runs the slab decomposition
instead (`_force_eval_sorted_decomp`, `parallel/decomp.py`): each rank
owns a slab of the global key order, re-owned every step by sampled
splitters and one all-to-all, exchanges only rim rows with its rank
neighbours, and sums its own rows against its rim-extended columns (the
`key_rows` form of the pair kernels); the PM mesh is deposited from the
slab and solved by the pencil solve, and the short range runs whole on a
wider rim.  Per-rank memory and traffic are O(N/D + rim).  Every health
counter but sink_slots_full is then the rank's own and is summed, and
decomp_pressure counts the slabs' capacity pressure.  'grid' and 'dense'
keep their gathered columns, as in the JAX package.  With `cfg.dt_bins >
1` the ranks take global steps, as `summersph_tpu/parallel/sharded.py:
148-174` does: `init_carries` still attaches the held far field with PM
gravity (`summersph_tpu/integrate.py:630-640`), and `pm_phase = i %
pm_every` decides each solve.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Optional

import torch

from .config import SimConfig
from .ops.cuda_pairs import density, forces, pair_eval, window_overflow
from .ops.density import compute_density
from .ops.eos import eos_update
from .ops.forces import compute_sph_forces
from .ops.gravity import gas_gravity_direct, sink_gravity
from .ops.pm_gravity import (PM_MODES, gas_gravity_pm, gas_gravity_pm_decomp,
                             gas_gravity_pm_held, pm_geometry,
                             pm_long_range_held, recompute_far_field)
from .ops.sinks import accrete, create_sinks, cull_bounds, merge_sinks
from .ops.smoothing import update_smoothing
from .ops.sorted_grid import (LANES, SORTED_MODES, sort_h_pad,
                               sort_particles)
from .ops.timestep import next_timestep
from .parallel.comm import (Mesh, all_gather_fields, axis_index,
                            gather_particles, psum)
from .parallel.decomp import (DecompAux, attach_density, build_cols,
                              exchange_rim, global_geometry, redistribute)
from .state import Particles, SimState, Sinks
from .tracing import span, traced


def check_supported(cfg: SimConfig, axis_name: Optional[Mesh] = None):
    """Raise TypeError for an `axis_name` that is not a `parallel.Mesh`
    (the JAX package's axis names are strings).  Every configuration runs
    on a mesh; with cfg.dt_bins > 1 it takes global steps there, as the
    JAX package's sharded steps do (`summersph_tpu/parallel/sharded.py:
    148-174`)."""
    if axis_name is not None and not isinstance(axis_name, Mesh):
        raise TypeError(f"axis_name must be a parallel.Mesh (make_mesh), "
                        f"not {axis_name!r}")


@traced("force_eval")
def force_eval(p: Particles, s: Sinks, cfg: SimConfig,
               axis_name: Optional[Mesh] = None, pm=None):
    """Sort -> density -> EOS -> SPH forces -> self-gravity -> sink gravity.

    Returns (particles with rho/P/cs/omega/acc/du/dalpha filled, sinks with
    acc, aux = (grid, grav_overflow, pm_r_s)).  grav_overflow is 0 except
    on a fused step whose r_cut exceeds the SPH cell; pm_r_s is the split
    the (possibly held) far field was built with when cfg.pm_every > 1,
    else None.  `pm` = (pm_phase, r_s_held, held_valid) drives the
    far-field subcycle (`pm_gravity.recompute_far_field`); None recomputes.
    The returned particles are in sorted order and may be padded beyond
    the caller's capacity; `step` and `prime` slice back (the dense engine
    keeps the caller's order).  With `axis_name` `p` is this rank's rows
    and the returned particles too: on the sorted engine its slab of the
    sorted order; under cfg.decomp='slab' its own slab of the global key
    order, and the aux's grid is a `parallel.decomp.DecompAux`.
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
    if cfg.neighbor_mode in SORTED_MODES:
        if axis_name is None:
            return _force_eval_sorted(p, s, cfg, pm)
        if cfg.decomp == "slab" and cfg.neighbor_mode == "sorted":
            return _force_eval_sorted_decomp(p, s, cfg, axis_name)
        return _force_eval_sorted_sharded(p, s, cfg, axis_name, pm)
    return _force_eval_dense(p, s, cfg, axis_name)


def _force_eval_dense(p: Particles, s: Sinks, cfg: SimConfig,
                      axis_name: Optional[Mesh]):
    """force_eval on the dense engine: every pair, in the caller's order.
    With `axis_name` the rows are this rank's and the columns the
    gathered set, gathered again after the density pass for its fields."""
    cols = gather_particles(p, axis_name) if axis_name is not None else None
    p = eos_update(compute_density(p, cfg, cols=cols), cfg)
    cols = gather_particles(p, axis_name) if axis_name is not None else None
    acc, du, dalpha = compute_sph_forces(p, cfg, cols=cols)

    grav_over = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    if cfg.gravity == "direct":
        acc = acc + gas_gravity_direct(p, cfg, cols=cols)
    elif cfg.gravity in PM_MODES:
        if axis_name is None:
            acc_pm, grav_over = gas_gravity_pm(p, cfg)
        else:
            # the gathered columns are the ranks' rows in rank order
            off = axis_index(axis_name) * p.capacity
            acc_pm, grav_over = gas_gravity_pm(cols, cfg, rows=(p, off),
                                               axis_name=axis_name)
        acc = acc + acc_pm
    acc_gas_sink, acc_sink = sink_gravity(p, s, axis_name)
    p = p.replace(acc=acc + acc_gas_sink, du=du, dalpha=dalpha)
    return p, s.replace(acc=acc_sink), (None, grav_over, None)


def _force_eval_sorted(p: Particles, s: Sinks, cfg: SimConfig, pm=None):
    """force_eval on the sorted window engine.  Self-gravity takes one of
    four branches: direct; TreePM with the short range fused into the
    force kernel; TreePM with the separate short-range kernel; either
    TreePM form with the far field held between solves (cfg.pm_every).
    With variable h the sort carries cell headroom (`sort_h_pad`:
    cfg.sort_h_pad, or 1.25 under 'grid'), so the same grid stays exact
    through the step's h-iteration."""
    p2, sgrid = sort_particles(p, cfg, h_pad=sort_h_pad(cfg))
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


def _force_eval_sorted_sharded(p: Particles, s: Sinks, cfg: SimConfig,
                               mesh: Mesh, pm=None):
    """The sorted engine on several ranks (gather mode).  Every rank
    gathers the particles, sorts the whole set with the same stable sort,
    and owns the contiguous slab of the sorted rows at rank x capacity:
    the density pass on its slab (the row-slab kernel), the EOS, one
    gather of (rho, P, cs, Omega) into the columns, the force pass on its
    slab, then gravity on its slab (the mesh and the short range summed
    over the ranks).  Two gathers and a replicated sort a step; the pair
    sums, the dominant cost, split over the ranks.  The per-rank capacity
    must be a multiple of max(sorted_block, 128), so that the sort adds
    no padding (`parallel.pad_state_to_devices`)."""
    nloc = p.capacity
    if nloc % max(cfg.sorted_block, LANES):
        raise ValueError(
            f"sharded sorted runs need the per-rank capacity ({nloc}) to be "
            f"a multiple of max(sorted_block, {LANES}) so the replicated "
            f"sort needs no extra padding; pad the state first "
            f"(parallel.pad_state_to_devices)")
    pf2, grid = sort_particles(gather_particles(p, mesh), cfg,
                               h_pad=sort_h_pad(cfg))
    off = axis_index(mesh) * nloc
    rows = pf2.map(lambda a: a[off:off + nloc])
    rows = eos_update(density(pf2, cfg, grid, rows=(rows, off)), cfg)
    rho, pres, cs, omega = all_gather_fields(
        [rows.rho, rows.pressure, rows.cs, rows.omega], mesh)
    pf2 = pf2.replace(rho=rho, pressure=pres, cs=cs, omega=omega)
    acc, du, dalpha = forces(pf2, cfg, grid, rows=(rows, off))

    grav_over = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    pm_r_s = None
    if cfg.gravity == "direct":
        acc = acc + gas_gravity_direct(rows, cfg, cols=pf2)
    elif cfg.gravity in PM_MODES:
        if cfg.pm_every > 1:
            phase, r_s_held, held_valid = pm or (None, None, False)
            acc_pm, grav_over, acc_long, pm_r_s = gas_gravity_pm_held(
                pf2, cfg, phase, r_s_held, held_valid, rows=(rows, off),
                axis_name=mesh)
            rows = rows.replace(acc_ext=acc_long)
        else:
            acc_pm, grav_over = gas_gravity_pm(pf2, cfg, rows=(rows, off),
                                               axis_name=mesh)
        acc = acc + acc_pm

    acc_gas_sink, acc_sink = sink_gravity(rows, s, mesh)
    rows = rows.replace(acc=acc + acc_gas_sink, du=du, dalpha=dalpha)
    return rows, s.replace(acc=acc_sink), (grid, grav_over, pm_r_s)


def _force_eval_sorted_decomp(p: Particles, s: Sinks, cfg: SimConfig,
                              mesh: Mesh):
    """The sorted engine under the slab decomposition (`parallel/decomp.py`).
    Every per-rank array is O(N/D + rim): the particles are re-owned into
    slabs of the global key order (sampled splitters, one all-to-all),
    each rank exchanges only rim rows with its rank neighbours, and the
    pair passes run its own rows against the local rim-extended columns
    (the `key_rows` form of the `_rows` kernels); between them one more
    rim exchange brings the rims' fresh density fields.  PM gravity
    deposits the slab and solves on the mesh summed over the ranks (the
    pencil solve where it tiles), and its short range runs on a wider rim
    (`pm_gravity.gas_gravity_pm_decomp`).  Capacity pressure (migration
    chunks, slabs, rims) is counted for the decomp_pressure slot."""
    nloc = p.capacity
    granule = max(cfg.sorted_block, LANES)
    if nloc % granule or cfg.halo_rows % LANES \
            or cfg.grav_halo_rows % LANES:
        raise ValueError(
            f"decomp='slab' needs the per-rank capacity ({nloc}), halo_rows "
            f"({cfg.halo_rows}) and grav_halo_rows ({cfg.grav_halo_rows}) "
            f"to be multiples of {granule}/{LANES}/{LANES}")
    h_pad = sort_h_pad(cfg)
    origin, cell = global_geometry(p, cfg, mesh, h_pad=h_pad)
    key_own, p2, _, n_mis, n_slab = redistribute(p, cfg, mesh, origin, cell)
    rim_l, rim_r = exchange_rim(key_own, p2, mesh, cfg.halo_rows,
                                hops=cfg.halo_hops)
    p_cols, grid, rim_short = build_cols(key_own, p2, rim_l, rim_r, cfg,
                                         origin, cell, h_pad)
    pressure = n_mis + n_slab + rim_short

    p2 = eos_update(density(p_cols, cfg, grid, rows=(p2, key_own)), cfg)
    p_cols = attach_density(key_own, p2, p_cols, mesh, cfg)
    acc, du, dalpha = forces(p_cols, cfg, grid, rows=(p2, key_own))

    grav_over = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    if cfg.gravity == "direct":
        acc = acc + gas_gravity_direct(p2, cfg,
                                       cols=gather_particles(p2, mesh))
    elif cfg.gravity in PM_MODES:
        acc_pm, grav_over, rim_short_g = gas_gravity_pm_decomp(
            p2, key_own, cell, cfg, mesh)
        acc = acc + acc_pm
        pressure = pressure + rim_short_g

    acc_gas_sink, acc_sink = sink_gravity(p2, s, mesh)
    p2 = p2.replace(acc=acc + acc_gas_sink, du=du, dalpha=dalpha)
    aux = DecompAux(grid=grid, cols=p_cols, key_rows=key_own,
                    pressure=pressure.to(torch.int32))
    return p2, s.replace(acc=acc_sink), (aux, grav_over, None)


@traced("kick")
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


@traced("drift")
def drift(p: Particles, s: Sinks, dt):
    """Full drift: x += v dt."""
    p = p.replace(pos=torch.where(p.alive[:, None], p.pos + dt * p.vel,
                                  p.pos))
    s = s.replace(pos=torch.where(s.alive[:, None], s.pos + dt * s.vel,
                                  s.pos))
    return p, s


def _coverage_stats(cfg: SimConfig, grid, grav_over, n_unconverged,
                    nonfinite, sink_full, decomp_pressure=None):
    """int32[len(STATS_FIELDS)] health counters for this step.  The window
    slots are 0 on the dense engine (no grid); the decomposition slot is
    0 outside the slab decomposition; a counter given as None is 0."""
    zero = torch.zeros((), dtype=torch.int32, device=grav_over.device)
    if grid is None:
        sph_over = clamped = zero
    else:
        sph_over, clamped = window_overflow(grid, cfg), grid.n_clamped

    def slot(c):
        return zero if c is None else c.to(torch.int32)

    return torch.stack([sph_over, clamped, slot(grav_over),
                        slot(n_unconverged), slot(nonfinite),
                        slot(sink_full), slot(decomp_pressure)])


def _count_nonfinite(p: Particles) -> torch.Tensor:
    """Live particles whose u, pos or vel went non-finite this step."""
    ok = (torch.isfinite(p.u) & torch.all(torch.isfinite(p.pos), dim=-1)
          & torch.all(torch.isfinite(p.vel), dim=-1))
    return torch.sum(p.alive & ~ok).to(torch.int32)


def step(state: SimState, cfg: SimConfig, axis_name: Optional[Mesh] = None,
         pm_phase: Optional[int] = None) -> SimState:
    """One full KDK step.  With `cfg.reuse_forces` it needs primed rates
    (see `prime`).  `pm_phase` (cfg.pm_every > 1): this step's host-side
    position in the far-field subcycle -- None or 0 solves the mesh,
    nonzero reuses the held force, after one device read of the held
    split (`run_steps` knows the held force is valid and skips it).  With
    `axis_name` (a `parallel.Mesh`) the step of this rank's rows."""
    return _step(state, cfg, axis_name, pm_phase, held_valid=False)


@traced("step")
def _step(state: SimState, cfg: SimConfig, axis_name: Optional[Mesh],
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

    with span("timestep"):
        t = state.t + dt
        dt = next_timestep(p, dt, cfg, axis_name)

    # the slab decomposition hands its local columns and grid on
    aux = grid if isinstance(grid, DecompAux) else None
    if aux is not None:
        grid = aux.grid

    n_unconverged = sink_full = None
    if cfg.fixed_h is None:
        if aux is not None:
            p, n_unconverged = update_smoothing(
                p, cfg, cols=aux.cols, grid=grid, axis_name=axis_name,
                key_rows=aux.key_rows)
        else:
            cols = (gather_particles(p, axis_name) if axis_name is not None
                    else None)
            p, n_unconverged = update_smoothing(p, cfg, cols=cols, grid=grid,
                                                axis_name=axis_name)
        s, sink_full = create_sinks(p, s, cfg, axis_name)

    p, s = accrete(p, s, axis_name)
    if cfg.sink_merge_factor > 0.0:
        # the sinks are replicated: merging needs no collective
        s, _ = merge_sinks(s, cfg)
    p, s = cull_bounds(p, s, cfg)

    with span("stats"):
        stats = _coverage_stats(cfg, grid, grav_over, n_unconverged,
                                _count_nonfinite(p), sink_full,
                                None if aux is None else aux.pressure)
        if aux is not None:
            # the slab decomposition's counters are all the rank's own
            # (local grids, local gravity, local pressure events) but
            # sink_slots_full (5), which the replicated sinks give every
            # rank alike
            summed = psum(stats, axis_name)
            stats = torch.cat([summed[:5], stats[5:6], summed[6:]])
        elif axis_name is not None:
            # the window counters (0-2) come from the replicated sort and
            # sink_slots_full (5) from replicated sinks: summing them
            # would multiply them by the rank count.  Only the per-rank
            # h-iteration (3) and non-finite (4) counts are summed.
            stats = torch.cat([stats[:3], psum(stats[3:5], axis_name),
                               stats[5:]])
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


@traced("prime")
def prime(state: SimState, cfg: SimConfig,
          axis_name: Optional[Mesh] = None) -> SimState:
    """Evaluate forces at the current positions (acc/du/dalpha and
    rho/P/cs/omega, and with cfg.pm_every > 1 a fresh acc_ext), as the
    carried-rate KDK needs before its first step.  The particle order
    comes back permuted (identity in pid).  With `axis_name` (a
    `parallel.Mesh`) `state` holds this rank's rows."""
    state = init_carries(state, cfg)
    cap0 = state.particles.capacity
    p, s, _ = force_eval(state.particles, state.sinks, cfg, axis_name)
    if p.capacity != cap0:
        p = p.map(lambda a: a[:cap0])
    return state.replace(particles=p, sinks=s)


@traced("segment")
def run_steps(state: SimState, cfg: SimConfig, n_steps: int,
              axis_name: Optional[Mesh] = None) -> SimState:
    """Advance exactly n_steps: global steps, or, with cfg.dt_bins > 1 on
    one device, base steps of the block-timestep engine
    (`blockstep.step_binned`).  The far-field phase is step % pm_every,
    pinned to this call: its first step solves the mesh, so a resumed
    state never starts from a stale held force, and the later steps know
    their held force is valid.  The
    returned `stats` is the running maximum of the per-step counters over
    these steps, so one bad step cannot hide.  With `axis_name` (a
    `parallel.Mesh`) the global steps of this rank's rows, whatever
    dt_bins says."""
    from .blockstep import _step_binned  # blockstep imports this module

    check_supported(cfg, axis_name)
    state = init_carries(state, cfg)
    state = state.replace(stats=torch.zeros_like(state.stats))
    every = max(cfg.pm_every, 1)
    for i in range(n_steps):
        if cfg.dt_bins > 1 and axis_name is None:
            out = _step_binned(state, cfg, i % every, held_valid=i > 0)
        else:
            out = _step(state, cfg, axis_name, i % every, held_valid=i > 0)
        with span("stats"):
            state = out.replace(stats=torch.maximum(out.stats, state.stats))
    return state


def check_coverage(state: SimState, cfg: SimConfig, warn: bool = True) -> int:
    """Neighbour candidates the pair passes would drop for the current
    particle distribution (`cuda_pairs.window_overflow`).  The kernels and
    their plain versions walk every window group's whole candidate range,
    so this is 0 and `warn` has nothing to warn about; the JAX package's
    static windows can drop pairs, and its signature is kept."""
    _, grid = sort_particles(state.particles, cfg, h_pad=sort_h_pad(cfg))
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
              max_steps: int = 1_000_000, steps_per_sync: int = 8,
              axis_name: Optional[Mesh] = None) -> SimState:
    """Advance until t >= t_stop, in `run_steps` segments of
    `steps_per_sync` steps with one host read of `t` between them.  It may
    overshoot t_stop by up to steps_per_sync - 1 steps, as the JAX
    package's `run_until` does.  With `axis_name` (a `parallel.Mesh`) t
    is replicated, so every rank reads the same value and runs the same
    segments."""
    check_supported(cfg, axis_name)
    t_stop = float(t_stop)
    done = 0
    while float(state.t) < t_stop and done < max_steps:
        state = run_steps(state, cfg, steps_per_sync, axis_name)
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
