"""Multi-device runs over `torch.distributed`, in gather mode and in the
slab decomposition.  Counterpart of `summersph_tpu/parallel/sharded.py`.

The particle arrays are split by rows across a 1-D mesh of ranks, one
process and one device each; sinks, t and dt are replicated.  Each step
all-gathers the particles, sorts the whole set on every rank (the same
stable sort, so every rank holds the same order), and each rank sums its
own contiguous 1/D slab of the sorted rows against all columns with the
row-slab form of the pair kernels; the PM mesh is deposited by each rank
from its rows and summed over the ranks.  Global quantities (dt, sink
accretion and gas->sink pull, the sink-creation argmax, two health
counters) go through the mesh's collectives (`parallel/comm.py`).  The
dense engine (`neighbor_mode='dense'`) runs the same way against the
gathered columns.

With `cfg.decomp='slab'` (and neighbor_mode='sorted') the same drivers run
the slab decomposition (`parallel/decomp.py`): a rank's rows are its own
slab of the global key order, re-owned every step, and it exchanges only
rim rows with its rank neighbours, so per-rank memory and traffic are
O(N/D + rim).  Its per-rank capacity must be a multiple of
max(cfg.sorted_block, 128) (pad with that granule) and at least
cfg.halo_rows and cfg.grav_halo_rows.  With cfg.dt_bins > 1 the ranks
take global steps, as the JAX package's sharded steps do
(`summersph_tpu/parallel/sharded.py:148-174`).

Where `shard_map` and `device_put` place a global array in the JAX
package, here the caller starts one process a rank and the process group
(`torchrun --nproc-per-node D`, or `torch.multiprocessing` with a
`file://` rendezvous), builds the same global state on every rank,
`pad_state_to_devices` and `shard_state` it; `gather_state` rebuilds the
global state on every rank, the counterpart of reading a sharded array
back.  The particles come back in the sorted order of the last step (in
slab mode: the slabs in rank order, each with its dead rows last), so
compare states per pid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..config import SimConfig
from ..integrate import check_supported, prime, run_steps, run_until, step
from ..state import Particles, SimState, Sinks
from .comm import Mesh, gather_particles


def make_mesh(n_devices: Optional[int] = None, group=None,
              device=None) -> Mesh:
    """The mesh of the process group the caller started (the default
    group unless `group` is given).  `n_devices`, when given, must be the
    group's size.  Rank r's device is cuda:(r % device_count) unless the
    caller names one (device='cpu' for gloo ranks on the CPU); without a
    visible card and no device named it raises."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: start the process group first "
            "(torch.distributed.init_process_group: 'nccl' on cards, "
            "'gloo' on the CPU)")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the process "
                         f"group has {size} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; pass "
                               "device='cpu' to run the ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(group=group, rank=rank, size=size,
                device=torch.device(device))


def state_specs(axis: str = "dp", kahan_u: bool = False,
                pm_held: bool = False) -> SimState:
    """Where each field of a SimState lives, in the JAX package's
    PartitionSpec terms: (axis,) for the particle fields, split by rows,
    () for the replicated sinks, t, dt, stats and pm_r_s; None for an
    optional field the state does not carry (u_c unless `kahan_u`, acc_ext
    and pm_r_s unless `pm_held`)."""
    def fill(cls, spec, skip=()):
        return cls(**{f.name: None if f.name in skip else spec
                      for f in dataclasses.fields(cls)})

    skip = () if kahan_u else ("u_c",)
    if not pm_held:
        skip += ("acc_ext",)
    return SimState(particles=fill(Particles, (axis,), skip),
                    sinks=fill(Sinks, ()), t=(), dt=(), stats=(),
                    pm_r_s=() if pm_held else None)


def pad_state_to_devices(state: SimState, n_devices: int,
                         granule: int = 128) -> SimState:
    """Pad the particle capacity with dead slots to a multiple of
    n_devices x granule, carrying u_c and acc_ext when present.  With
    granule 128 every rank's slab stays a multiple of the sort's padding
    granule, which gather mode's sorted engine requires; the slab
    decomposition needs max(cfg.sorted_block, 128)."""
    old = state.particles
    cap = old.capacity
    rem = (-cap) % (n_devices * max(granule, 1))
    if rem == 0:
        return state
    tail = Particles.zeros(cap + rem, old.pos.dtype,
                           old.pos.device).map(lambda a: a[cap:])

    def cat(name):
        a = getattr(old, name)
        if a is None:
            return None
        b = getattr(tail, name)
        if b is None:  # the optional carries pad with zeros
            b = a.new_zeros((rem,) + tuple(a.shape[1:]))
        return torch.cat([a, b])

    return state.replace(particles=old.replace(**{
        f.name: cat(f.name) for f in dataclasses.fields(old)}))


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """This rank's share of a global state, on its device: the particle
    rows [rank x n / D, (rank + 1) x n / D) (copies, so the global state
    may go), everything else replicated."""
    n = state.particles.capacity
    if n % mesh.size:
        raise ValueError(f"shard_state: capacity {n} does not split over "
                         f"{mesh.size} ranks (pad_state_to_devices first)")
    nloc = n // mesh.size
    lo = mesh.rank * nloc

    def put(a):
        return a.to(mesh.device, copy=True)

    return state.replace(
        particles=state.particles.map(lambda a: put(a[lo:lo + nloc])),
        sinks=state.sinks.map(put), t=put(state.t), dt=put(state.dt),
        stats=put(state.stats),
        pm_r_s=None if state.pm_r_s is None else put(state.pm_r_s))


def gather_state(state: SimState, mesh: Mesh) -> SimState:
    """The global state on every rank: every rank's particle rows in rank
    order (one collective), the replicated fields as they are.  The dead
    rows take, in ascending order, the pids that no live row holds, so
    that each pid of [0, n) appears once: a dead row of a slab may carry
    the pid of a particle that migrated to another rank."""
    p = gather_particles(state.particles, mesh)
    n = p.capacity
    taken = torch.zeros(n, dtype=torch.bool, device=p.pid.device)
    live = p.pid[p.alive].long()
    taken[live[live < n]] = True
    free = torch.nonzero(~taken).flatten()
    dead = ~p.alive
    if free.shape[0] == int(dead.sum()):
        pid = p.pid.clone()
        pid[dead] = free.to(pid.dtype)
        p = p.replace(pid=pid)
    return state.replace(particles=p)


def make_sharded_prime(cfg: SimConfig, mesh: Mesh):
    """state -> state with the forces at the current positions:
    `integrate.prime` on the mesh, each rank on its rows."""
    check_supported(cfg, mesh)
    return lambda state: prime(state, cfg, axis_name=mesh)


def make_sharded_step(cfg: SimConfig, mesh: Mesh):
    """state -> state after one `integrate.step` on the mesh."""
    check_supported(cfg, mesh)
    return lambda state: step(state, cfg, axis_name=mesh)


def make_sharded_run_steps(cfg: SimConfig, mesh: Mesh, n_steps: int = 8):
    """state -> state after `integrate.run_steps` of n_steps on the mesh."""
    check_supported(cfg, mesh)
    return lambda state: run_steps(state, cfg, n_steps, axis_name=mesh)


def sharded_run_until(state: SimState, t_stop, cfg: SimConfig, mesh: Mesh,
                      max_steps: int = 1_000_000,
                      steps_per_sync: int = 8) -> SimState:
    """`integrate.run_until` on the mesh: segments of `steps_per_sync`
    steps until the replicated t reaches t_stop."""
    return run_until(state, t_stop, cfg, max_steps, steps_per_sync,
                     axis_name=mesh)


__all__ = ["make_mesh", "state_specs", "pad_state_to_devices", "shard_state",
           "gather_state", "make_sharded_prime", "make_sharded_step",
           "make_sharded_run_steps", "sharded_run_until"]
