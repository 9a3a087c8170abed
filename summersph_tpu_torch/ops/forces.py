"""The dense O(N^2) SPH force pass: pressure, Monaghan viscosity and the
Morris-Monaghan alpha rate over every column.  Counterpart of the dense
path of `summersph_tpu/ops/forces.py`, with the same row / column split
as `ops/density.py` and the pair algebra of `ops/pairs.py`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SimConfig
from ..state import Particles
from ..tracing import traced
from ..utils.blocks import pick_block, row_blocks, unblock
from . import pairs

# Pair elements per temporary of a row block (about 40 temporaries).
FORCE_BUDGET = 1 << 20


class ColFields(NamedTuple):
    """Column-side pair fields as separate [N] tensors."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    h: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    om: torch.Tensor
    cs: torch.Tensor
    al: torch.Tensor
    m: torch.Tensor
    alive: torch.Tensor

    @classmethod
    def of(cls, c: Particles) -> "ColFields":
        return cls(x=c.pos[:, 0], y=c.pos[:, 1], z=c.pos[:, 2],
                   vx=c.vel[:, 0], vy=c.vel[:, 1], vz=c.vel[:, 2],
                   h=c.h, p=c.pressure, rho=c.rho, om=c.omega, cs=c.cs,
                   al=c.alpha, m=torch.where(c.alive, c.mass, 0.0),
                   alive=c.alive)


def _dense_block(idx, rows: Particles, cf: ColFields, cfg: SimConfig):
    """(ax, ay, az, du, alpha_raw) of the rows `idx` [B] against all
    columns."""
    def row(a):
        return a[idx][:, None]

    def col(a):
        return a[None, :]

    xi, vi = rows.pos[idx], rows.vel[idx]
    return pairs.force_sums(
        xi[:, 0:1] - col(cf.x), xi[:, 1:2] - col(cf.y),
        xi[:, 2:3] - col(cf.z), vi[:, 0:1] - col(cf.vx),
        vi[:, 1:2] - col(cf.vy), vi[:, 2:3] - col(cf.vz),
        row(rows.h), col(cf.h), row(rows.pressure), col(cf.p),
        row(rows.rho), col(cf.rho), row(rows.omega), col(cf.om),
        row(rows.cs), col(cf.cs), row(rows.alpha), col(cf.al),
        col(cf.m), col(cf.alive), cfg)


@traced("force")
def compute_sph_forces(rows: Particles, cfg: SimConfig,
                       cols: Particles | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(acc_hydro [N, 3], du [N], dalpha [N]) of the rows, zero on dead
    rows; dalpha carries the switch's decay term.  `rows` and `cols` must
    carry rho, P, Omega and cs from the density pass.  The JAX package's
    hashed cell grid (its `grid` argument) is not ported: the port runs
    `neighbor_mode='grid'` on the sorted engine."""
    cols = cols if cols is not None else rows
    cf = ColFields.of(cols)
    cap = rows.capacity
    blocks = row_blocks(cap, pick_block(cap, cols.capacity, FORCE_BUDGET),
                        rows.pos.device)
    sums = [_dense_block(idx, rows, cf, cfg) for idx in blocks]
    ax, ay, az, du, araw = (unblock(torch.stack([s[k] for s in sums]), cap)
                            for k in range(5))
    acc = torch.stack([ax, ay, az], dim=-1)
    dalpha = pairs.alpha_rate(araw, rows.rho, rows.alpha, rows.cs, rows.h,
                              cfg)
    alive = rows.alive
    return (torch.where(alive[:, None], acc, 0.0),
            torch.where(alive, du, 0.0), torch.where(alive, dalpha, 0.0))


__all__ = ["compute_sph_forces", "ColFields", "FORCE_BUDGET"]
