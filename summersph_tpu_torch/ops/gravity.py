"""Softened gas-gas gravity (exact all pairs) and direct sink gravity.

Counterpart of `summersph_tpu/ops/gravity.py`.  `gas_gravity_direct` is
the exact oracle the TreePM path (`ops/pm_gravity.py`) is held against,
and serves `gravity='direct'`: receiver-side spline softening f(r / h_i)
within 2h, Newtonian outside, a pure r > 0 guard.  Sink gravity is direct
and unsoftened.  On several devices (`axis_name`, a `parallel.Mesh`) the
rows are a rank's, the columns the gathered set, and the gas->sink pull
is summed over the ranks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SimConfig
from ..state import Particles, Sinks
from ..tracing import traced
from ..parallel.comm import psum
from ..utils.units import G
from . import cuda_sinks
from .cuda_pairs import _on_cpu
from .kernels import grav_softening

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
    cuda_sinks.count_live(s)
    if _on_cpu(p.pos):
        return sink_gravity_plain(p, s, axis_name)
    return cuda_sinks.sink_gravity_cuda(p, s, axis_name)


__all__ = ["gas_gravity_direct", "sink_gravity", "sink_gravity_plain"]
