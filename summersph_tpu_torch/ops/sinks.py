"""Sink accretion, creation, merging and bounds culling.  Counterpart of
`summersph_tpu/ops/sinks.py`, whose docstrings list the deliberate
corrections of the reference, all kept here:
* accretion: nearest sink only, Euclidean distance, accreted angular
  momentum kept in `spin`;
* creation: every candidate is scanned, the densest eligible one wins, the
  zero-mass dummy sink of a sinkless IC vetoes nothing, at most one sink is
  created per call, and full slots are reported (`slots_full`);
* merging (the reference's empty `check_sink_merger` stub, implemented):
  sinks closer than `sink_merge_factor` x the smaller radius merge,
  conserving mass, momentum and angular momentum.

Each function dispatches by device: on the CPU its plain version
(`accrete_plain`, `create_sinks_plain`, `merge_sinks_plain`), a masked
tensor op over the fixed capacities with no device read ([S, N] for the
gas, [S, S] for the sinks); on the card the kernels of
`ops/cuda_sinks.py`, one pass over the particles and one block for the
sinks, with no [S, N] temporary and no device read.  `cull_bounds` has
one form.  On several devices (`axis_name`, a `parallel.Mesh`) the gas
is a rank's rows and the sinks are replicated: accretion sums its
per-sink sums over the ranks, creation takes the densest candidate of all
ranks, and merging, which reads the sinks only, needs no collective.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SimConfig
from ..parallel.comm import all_gather_tiled, psum
from ..state import PARK_POSITION, Particles, Sinks
from ..tracing import traced
from . import cuda_sinks
from .cuda_pairs import _on_cpu


def accrete_plain(p: Particles, s: Sinks,
                  axis_name=None) -> Tuple[Particles, Sinks]:
    """Plain PyTorch version of `accrete`: sinks absorb the live gas inside
    their accretion radius.

    Conserves mass, momentum and angular momentum: each particle goes to
    its nearest eligible sink, the sink moves to the combined centre of
    mass with the combined momentum, and the gas's angular momentum about
    the old sink frame adds to `spin`.  Accreted slots die and are parked.
    [S, N] layout with masked reductions, no scatter.  With `axis_name`
    the per-sink sums (mass, momentum, mass-weighted position, angular
    momentum) are summed over the ranks in one collective of one [S, 10]
    buffer.
    """
    S = s.capacity
    d2 = torch.zeros((S, p.capacity), dtype=p.pos.dtype, device=p.pos.device)
    for c in range(3):
        d = s.pos[:, c][:, None] - p.pos[:, c][None, :]
        d2 = d2 + d * d
    eligible = (p.alive[None, :] & s.alive[:, None]
                & (s.mass[:, None] > 0.0)
                & (d2 < (s.radius * s.radius)[:, None]))

    nearest = torch.argmin(torch.where(eligible, d2, torch.inf), dim=0)
    accreted = torch.any(eligible, dim=0)
    claim = eligible & (torch.arange(S, device=p.pos.device)[:, None]
                        == nearest[None, :])                     # [S, N]

    m = torch.where(accreted, p.mass, 0.0)
    w = torch.where(claim, m[None, :], 0.0)                      # [S, N]
    msum = torch.sum(w, dim=1)

    def sink_field_at_gas(f):                                    # [S] -> [N]
        return torch.sum(torch.where(claim, f[:, None], 0.0), dim=0)

    px = [p.pos[:, c] for c in range(3)]
    vx = [p.vel[:, c] for c in range(3)]
    psum_ = torch.stack([torch.sum(w * vx[c][None, :], dim=1)
                         for c in range(3)], dim=-1)
    xsum = torch.stack([torch.sum(w * px[c][None, :], dim=1)
                        for c in range(3)], dim=-1)
    rx = [px[c] - sink_field_at_gas(s.pos[:, c]) for c in range(3)]
    rv = [vx[c] - sink_field_at_gas(s.vel[:, c]) for c in range(3)]
    cross = (rx[1] * rv[2] - rx[2] * rv[1],
             rx[2] * rv[0] - rx[0] * rv[2],
             rx[0] * rv[1] - rx[1] * rv[0])
    lsum = torch.stack([torch.sum(w * cross[c][None, :], dim=1)
                        for c in range(3)], dim=-1)
    if axis_name is not None:
        sums = psum(torch.cat([msum[:, None], psum_, xsum, lsum], dim=1),
                    axis_name)
        msum, psum_, xsum, lsum = sums[:, 0], sums[:, 1:4], sums[:, 4:7], \
            sums[:, 7:]

    new_mass = s.mass + msum
    grew = msum > 0.0
    inv = torch.where(grew, 1.0 / torch.where(grew, new_mass, 1.0), 0.0)
    new_pos = torch.where(grew[:, None],
                          (s.mass[:, None] * s.pos + xsum) * inv[:, None],
                          s.pos)
    new_vel = torch.where(grew[:, None],
                          (s.mass[:, None] * s.vel + psum_) * inv[:, None],
                          s.vel)

    s = s.replace(mass=new_mass, pos=new_pos, vel=new_vel,
                  spin=s.spin + lsum)
    p = p.replace(
        alive=p.alive & ~accreted,
        mass=torch.where(accreted, 0.0, p.mass),
        pos=torch.where(accreted[:, None], PARK_POSITION, p.pos),
        vel=torch.where(accreted[:, None], 0.0, p.vel))
    return p, s


def create_sinks_plain(p: Particles, s: Sinks, cfg: SimConfig,
                       axis_name=None) -> Tuple[Sinks, torch.Tensor]:
    """Plain PyTorch version of `create_sinks`: spawn a sink at the
    densest eligible particle, if any.

    Eligible: live, code density m (eta / h)^3 above
    `cfg.sink_create_density`, and not within radius_j + 2 h_i of a real
    (live, massive) sink.  The new sink takes the first free slot, the
    particle's position and velocity, radius 2 h and mass
    `cfg.sink_create_mass`; the particle itself stays alive for the next
    accretion pass.  Returns (sinks, slots_full), slots_full int32 1 when
    a candidate found no free slot.  With `axis_name` every rank's best
    candidate (its density, position, velocity and h: one [8] row) is
    gathered and every rank takes the first densest, as `jnp.argmax` over
    the gathered values does, so ties go to the lowest rank.
    """
    S = s.capacity
    code_density = p.mass * (cfg.eta / p.h) ** 3
    d2 = torch.zeros((S, p.capacity), dtype=p.pos.dtype, device=p.pos.device)
    for c in range(3):
        d = s.pos[:, c][:, None] - p.pos[:, c][None, :]
        d2 = d2 + d * d
    reach = s.radius[:, None] + 2.0 * p.h[None, :]
    real = s.alive & (s.mass > 0)
    near_sink = torch.any(real[:, None] & (d2 < reach * reach), dim=0)
    eligible = (p.alive & (code_density > cfg.sink_create_density)
                & ~near_sink)

    has_any = torch.any(eligible)
    # the first maximum, as jnp.argmax; garbage when !has_any, gated below
    best = torch.argmax(torch.where(eligible, code_density,
                                    -torch.inf)).reshape(1)
    cand_pos = torch.index_select(p.pos, 0, best)[0]
    cand_vel = torch.index_select(p.vel, 0, best)[0]
    cand_h = torch.index_select(p.h, 0, best)[0]
    if axis_name is not None:
        best_val = torch.where(has_any, torch.index_select(
            code_density, 0, best)[0], -torch.inf)
        cand = all_gather_tiled(torch.cat([best_val[None], cand_pos,
                                           cand_vel, cand_h[None]]),
                                axis_name).reshape(-1, 8)
        # index_select: a 0-d tensor index would read it on the host
        win = torch.index_select(cand, 0,
                                 torch.argmax(cand[:, 0]).reshape(1))[0]
        has_any = torch.isfinite(win[0])
        cand_pos, cand_vel, cand_h = win[1:4], win[4:7], win[7]

    free = ~s.alive
    has_slot = torch.any(free)
    slot = torch.argmax(free.to(torch.int32))   # the first free slot

    write = ((torch.arange(S, device=p.pos.device) == slot)
             & has_any & has_slot)
    s = s.replace(
        alive=s.alive | write,
        pos=torch.where(write[:, None], cand_pos, s.pos),
        vel=torch.where(write[:, None], cand_vel, s.vel),
        acc=torch.where(write[:, None], 0.0, s.acc),
        spin=torch.where(write[:, None], 0.0, s.spin),
        mass=torch.where(write, cfg.sink_create_mass, s.mass),
        radius=torch.where(write, 2.0 * cand_h, s.radius))
    return s, (has_any & ~has_slot).to(torch.int32)


def merge_sinks_plain(s: Sinks, cfg: SimConfig
                      ) -> Tuple[Sinks, torch.Tensor]:
    """Plain PyTorch version of `merge_sinks`: merge real sinks closer than
    `cfg.sink_merge_factor` x min(radius_i, radius_j).

    Every sink points at the lower of itself and its lowest-index partner,
    and S.bit_length() rounds of pointer jumping follow the pointers to a
    root, a sink that points at itself.  Every local index minimum along a
    chain is a root, so a chain whose slots do not fall in index order
    merges in parts, one a root, and the parts merge on a later call only
    if they are still within reach then (the rule of the JAX package's
    `merge_sinks`).  A root takes the combined mass, the centre of mass
    position and velocity, the largest radius, and the total angular
    momentum (spins plus the members' orbital L about the new centre);
    absorbed slots die.  Returns (sinks, n_merged), the absorbed count.
    """
    S = s.capacity
    dev = s.pos.device
    real = s.alive & (s.mass > 0.0)
    d2 = torch.zeros((S, S), dtype=s.pos.dtype, device=dev)
    for c in range(3):
        d = s.pos[:, c][:, None] - s.pos[:, c][None, :]
        d2 = d2 + d * d
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    rmin = torch.minimum(s.radius[:, None], s.radius[None, :])
    thresh = cfg.sink_merge_factor * rmin
    pair = (real[:, None] & real[None, :] & (d2 < thresh * thresh)
            & (idx[:, None] != idx[None, :]))

    partner_min = torch.amin(torch.where(pair, idx[None, :], S), dim=1)
    target = torch.minimum(idx, partner_min)
    for _ in range(max(1, S.bit_length())):
        target = target[target]

    absorbed = real & (target != idx)
    # claim[r, j]: sink j (j == r included) contributes to root r
    claim = real[None, :] & (idx[:, None] == target[None, :])
    w = torch.where(claim, s.mass[None, :], 0.0)                 # [S, S]
    msum = torch.sum(w, dim=1)
    xsum = torch.einsum("rj,jc->rc", w, s.pos)
    vsum = torch.einsum("rj,jc->rc", w, s.vel)

    merged = msum > 0.0
    inv = torch.where(merged, 1.0 / torch.where(merged, msum, 1.0), 0.0)
    com_pos = xsum * inv[:, None]
    com_vel = vsum * inv[:, None]

    rel_x = s.pos[None, :, :] - com_pos[:, None, :]              # [S, S, 3]
    rel_v = s.vel[None, :, :] - com_vel[:, None, :]
    orb = torch.linalg.cross(rel_x, rel_v, dim=-1)
    lsum = (torch.einsum("rj,jc->rc", claim.to(s.spin.dtype), s.spin)
            + torch.sum(w[:, :, None] * orb, dim=1))
    rad = torch.amax(torch.where(claim, s.radius[None, :], 0.0), dim=1)

    root = real & ~absorbed
    upd = root & merged
    s = s.replace(
        alive=s.alive & ~absorbed,
        mass=torch.where(absorbed, 0.0, torch.where(upd, msum, s.mass)),
        pos=torch.where(absorbed[:, None], PARK_POSITION,
                        torch.where(upd[:, None], com_pos, s.pos)),
        vel=torch.where(absorbed[:, None], 0.0,
                        torch.where(upd[:, None], com_vel, s.vel)),
        spin=torch.where(absorbed[:, None], 0.0,
                         torch.where(upd[:, None], lsum, s.spin)),
        radius=torch.where(absorbed, 0.0, torch.where(upd, rad, s.radius)))
    return s, torch.sum(absorbed).to(torch.int32)


@traced("accrete")
def accrete(p: Particles, s: Sinks,
            axis_name=None) -> Tuple[Particles, Sinks]:
    """(particles, sinks) of `accrete_plain`.  CPU tensors take it; CUDA
    tensors the kernels (`ops/cuda_sinks.py`)."""
    cuda_sinks.count_live(s)
    if _on_cpu(p.pos):
        return accrete_plain(p, s, axis_name)
    return cuda_sinks.accrete_cuda(p, s, axis_name)


@traced("create_sinks")
def create_sinks(p: Particles, s: Sinks, cfg: SimConfig,
                 axis_name=None) -> Tuple[Sinks, torch.Tensor]:
    """(sinks, slots_full) of `create_sinks_plain`.  CPU tensors take it;
    CUDA tensors the kernels (`ops/cuda_sinks.py`)."""
    cuda_sinks.count_live(s)
    if _on_cpu(p.pos):
        return create_sinks_plain(p, s, cfg, axis_name)
    return cuda_sinks.create_sinks_cuda(p, s, cfg, axis_name)


@traced("merge_sinks")
def merge_sinks(s: Sinks, cfg: SimConfig) -> Tuple[Sinks, torch.Tensor]:
    """(sinks, n_merged) of `merge_sinks_plain`.  CPU tensors take it;
    CUDA tensors the kernel (`ops/cuda_sinks.py`)."""
    cuda_sinks.count_live(s)
    if _on_cpu(s.pos):
        return merge_sinks_plain(s, cfg)
    return cuda_sinks.merge_sinks_cuda(s, cfg)


@traced("cull")
def cull_bounds(p: Particles, s: Sinks,
                cfg: SimConfig) -> Tuple[Particles, Sinks]:
    """Mask out particles and sinks outside the bounding box."""
    keep_p = p.alive & torch.all(torch.abs(p.pos) <= cfg.bounding_size,
                                 dim=-1)
    gone_p = p.alive & ~keep_p
    p = p.replace(
        alive=keep_p,
        mass=torch.where(gone_p, 0.0, p.mass),
        pos=torch.where(gone_p[:, None], PARK_POSITION, p.pos),
        vel=torch.where(gone_p[:, None], 0.0, p.vel))
    keep_s = s.alive & torch.all(torch.abs(s.pos) <= cfg.bounding_size,
                                 dim=-1)
    gone_s = s.alive & ~keep_s
    s = s.replace(
        alive=keep_s,
        mass=torch.where(gone_s, 0.0, s.mass),
        pos=torch.where(gone_s[:, None], PARK_POSITION, s.pos),
        vel=torch.where(gone_s[:, None], 0.0, s.vel))
    return p, s


__all__ = ["accrete", "create_sinks", "merge_sinks", "cull_bounds",
           "accrete_plain", "create_sinks_plain", "merge_sinks_plain"]
