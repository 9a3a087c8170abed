"""Gas self-gravity, the one place that decides which form a force
evaluation runs, and direct sink gravity.

Counterpart of `summersph_tpu/ops/gravity.py`.  `gas_gravity_direct` is
the exact oracle the TreePM path (`ops/pm_gravity.py`) is held against,
and serves `gravity='direct'`: receiver-side spline softening f(r / h_i)
within 2h, Newtonian outside, a pure r > 0 guard.  Sink gravity is direct
and unsoftened.  On several devices (`axis_name`, a `parallel.Mesh`) the
rows are a rank's, the columns the gathered set, and the gas->sink pull
is summed over the ranks.

The self-gravity seam is one pair of calls that every engine of
`integrate.py` and the block substep make: `far_field_plan` before the
sort (does this evaluation solve the mesh or hold the far field of an
earlier solve, and with the fused short range the split the force kernel
and the sort's cell need) and `gas_gravity` after the pair passes
(direct; TreePM with the fused or the separate short range, solved or
held; the slab decomposition's TreePM).  No caller reads cfg.gravity,
cfg.pm_every or cfg.grav_fuse_short: `run_steps` takes each step's host
phase in the far-field subcycle from `far_field_phase`, and whether the
far field is kept for later steps follows from the state: rows that
carry `acc_ext` (attached by `integrate.init_carries`) keep it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SimConfig
from ..state import Particles, Sinks
from ..tracing import traced
from ..parallel.comm import gather_particles, psum
from ..utils.units import G
from . import cuda_sinks
from .cuda_pairs import _on_cpu
from .kernels import grav_softening
from .pm_gravity import (PM_MODES, gas_gravity_pm_decomp, pm_geometry,
                         pm_long_range, pm_short_range, recompute_far_field)

# Pair elements per row block of `gas_gravity_direct`, which bounds its
# memory (about 10 temporaries of this many elements).
DIRECT_BUDGET = 1 << 22


@traced("gravity_direct")
def gas_gravity_direct(rows: Particles, cfg: SimConfig,
                       cols: Particles | None = None) -> torch.Tensor:
    """Exact softened gas-gas gravity on `rows` from every particle of
    `cols` (the rows themselves by default), in blocks of rows; zero on
    dead rows."""
    cols = cols if cols is not None else rows
    cm = torch.where(cols.alive, cols.mass, 0.0)
    acc = torch.empty_like(rows.pos)
    block = max(1, DIRECT_BUDGET // max(cols.capacity, 1))
    for r0 in range(0, rows.capacity, block):
        xi = rows.pos[r0:r0 + block]
        d = [xi[:, c:c + 1] - cols.pos[None, :, c] for c in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = torch.sqrt(r2)
        valid = r > 0.0
        f = grav_softening(r, rows.h[r0:r0 + block, None])
        inv_r3 = torch.where(valid, 1.0 / torch.where(valid, r2 * r, 1.0),
                             0.0)
        coef = -G * cm[None, :] * f * inv_r3
        acc[r0:r0 + block] = torch.stack(
            [torch.sum(coef * d[c], dim=-1) for c in range(3)], dim=-1)
    return torch.where(rows.alive[:, None], acc, 0.0)


def sink_gravity_plain(p: Particles, s: Sinks, axis_name=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `sink_gravity`.  (acc_gas [N, 3], acc_sink
    [S, 3]); masked pairs and coincident points contribute zero.  [S, N]
    per-component layout, no [N, S, 3] intermediate.  With `axis_name` `p`
    is a rank's rows, and the gas's pull on the sinks is summed over the
    ranks (the sink<->sink part is replicated and is not)."""
    dxc = [s.pos[:, c][:, None] - p.pos[:, c][None, :] for c in range(3)]
    r2 = dxc[0] * dxc[0] + dxc[1] * dxc[1] + dxc[2] * dxc[2]
    valid = p.alive[None, :] & s.alive[:, None] & (r2 > 0.0)
    inv_r = torch.rsqrt(torch.clamp(r2, min=1.0e-12))
    w = torch.where(valid, G * (inv_r * inv_r * inv_r), 0.0)  # G/r^3

    wm_s = w * s.mass[:, None]                                 # [S, N]
    wm_p = w * torch.where(p.alive, p.mass, 0.0)[None, :]
    acc_gas = torch.stack([torch.sum(wm_s * dxc[c], dim=0)
                           for c in range(3)], dim=-1)
    acc_sink = torch.stack([-torch.sum(wm_p * dxc[c], dim=1)
                            for c in range(3)], dim=-1)
    if axis_name is not None:
        acc_sink = psum(acc_sink, axis_name)

    ds = s.pos[:, None, :] - s.pos[None, :, :]                 # [S, S, 3]
    r2s = torch.sum(ds * ds, dim=-1)
    rs = torch.sqrt(r2s)
    vs = s.alive[:, None] & s.alive[None, :] & (rs > 0.0)
    ws = torch.where(vs, G / torch.where(vs, r2s * rs, 1.0), 0.0)
    acc_ss = -torch.sum((ws * s.mass[None, :])[..., None] * ds, dim=1)

    return (torch.where(p.alive[:, None], acc_gas, 0.0),
            torch.where(s.alive[:, None], acc_sink + acc_ss, 0.0))


@traced("sink_gravity")
def sink_gravity(p: Particles, s: Sinks, axis_name=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct, unsoftened sink gravity: (acc_gas [N, 3], acc_sink [S, 3])
    of `sink_gravity_plain`.  CPU tensors take it; CUDA tensors the
    kernels (`ops/cuda_sinks.py`: one pass over the particles, one block
    for the sinks)."""
    if _on_cpu(p.pos):
        return sink_gravity_plain(p, s, axis_name)
    return cuda_sinks.sink_gravity_cuda(p, s, axis_name)


def far_field_phase(cfg: SimConfig, i: int) -> int:
    """Step i of a segment's place in the far-field subcycle, a host
    integer: i % cfg.pm_every, so that a segment's first step solves."""
    return i % max(cfg.pm_every, 1)


class FarField(NamedTuple):
    """What `far_field_plan` decided before the sort."""
    solve: bool                         # this evaluation solves the mesh
    r_s_held: Optional[torch.Tensor]    # the held far field's split
    split: Optional[tuple]              # fused: (r_s, r_cut) of the kernel

    @property
    def min_cell(self):
        """The sort's least cell: r_cut on a fused evaluation, whose short
        range rides the SPH windows, which hold every pair within r_cut
        once the cell is at least r_cut."""
        return None if self.split is None else self.split[1]


def far_field_plan(p: Particles, cfg: SimConfig, pm=None) -> FarField:
    """The self-gravity decisions an evaluation on `p` makes before its
    sort.  `pm` = (pm_phase, r_s_held, held_valid) places it in the
    far-field subcycle (`pm_gravity.recompute_far_field`); None solves,
    and so do rows that carry no held far field (`acc_ext`).  With
    cfg.grav_fuse_short the split of the fused force kernel: the one the
    far field will be solved with on `p` (`pm_geometry` reads the live
    box, whatever the rows' order), or on a held evaluation the held
    one."""
    if cfg.gravity not in PM_MODES:
        return FarField(False, None, None)
    phase, r_s_held, held_valid = pm or (None, None, False)
    solve = p.acc_ext is None or recompute_far_field(phase, r_s_held,
                                                     held_valid)
    split = None
    if cfg.grav_fuse_short:
        r_s = pm_geometry(p, cfg)[2] if solve else r_s_held.to(p.pos.dtype)
        split = (r_s, cfg.effective_rcut_rs() * r_s)
    return FarField(solve, r_s_held, split)


class SelfGravity(NamedTuple):
    """What `gas_gravity` returns."""
    acc: torch.Tensor           # the caller's acc plus gas self-gravity
    over: torch.Tensor          # int32 rows whose short range lost pairs
    held: Optional[tuple]       # (acc_long, r_s) the rows carry, or None
    rim_short: torch.Tensor     # int32 slab rows beyond the gravity rim


def gas_gravity(p: Particles, cfg: SimConfig, plan: FarField, acc,
                fused_acc=None, rows=None, axis_name=None,
                active_rows=None, decomp=None) -> SelfGravity:
    """`acc` plus the gas self-gravity of cfg.gravity on the rows: direct
    (`gas_gravity_direct`), or TreePM, its far field solved or held as
    `plan` says (`pm_long_range`, or the rows' `acc_ext` at the held
    split) and its short range fused (`fused_acc`, the force kernel's at
    `plan.split`) or separate (`pm_short_range` at the far field's split).

    `p` is the set the rows see: the rows themselves, or with `rows` =
    (p_rows, offset) and `axis_name` the gathered set of which p_rows is
    this rank's slab (gather mode).  `active_rows` [N] bool gates the
    separate short range to a block substep's closing rows.  `decomp` =
    (key_own, cell_sph): `p` is this rank's own slab under the slab
    decomposition, whose TreePM (`gas_gravity_pm_decomp`) solves every
    evaluation and counts the rows its rim cut short in `rim_short` (0
    elsewhere).  `held` is (acc_long, r_s) when the rows carry a held far
    field, for the caller to keep in acc_ext and SimState.pm_r_s; the
    overflow count is always 0 (the short range covers every window)."""
    zero = torch.zeros((), dtype=torch.int32, device=acc.device)
    p_rows = p if rows is None else rows[0]
    if cfg.gravity == "direct":
        cols = p if rows is not None else (
            gather_particles(p, axis_name) if decomp is not None else None)
        return SelfGravity(acc + gas_gravity_direct(p_rows, cfg, cols=cols),
                           zero, None, zero)
    if cfg.gravity not in PM_MODES:
        return SelfGravity(acc, zero, None, zero)
    if decomp is not None:
        acc_pm, over, rim_short = gas_gravity_pm_decomp(p, *decomp, cfg,
                                                        axis_name)
        return SelfGravity(acc + acc_pm, over, None, rim_short)
    if plan.solve:
        acc_long, _, _, r_s = pm_long_range(p, cfg, rows, axis_name)
    else:
        acc_long, r_s = p_rows.acc_ext, plan.r_s_held.to(p.pos.dtype)
    held = None if p_rows.acc_ext is None else (acc_long, r_s)
    if fused_acc is not None:
        return SelfGravity(acc + acc_long + fused_acc, zero, held, zero)
    acc_short, over = pm_short_range(p, cfg, r_s, rows, axis_name,
                                     active_rows)
    if active_rows is not None:     # the block substep's order of the sum
        return SelfGravity(acc + acc_long + acc_short, over, held, zero)
    return SelfGravity(acc + (acc_long + acc_short), over, held, zero)


__all__ = ["gas_gravity_direct", "sink_gravity", "sink_gravity_plain",
           "far_field_phase", "FarField", "far_field_plan", "SelfGravity",
           "gas_gravity"]
