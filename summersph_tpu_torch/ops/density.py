"""The dense O(N^2) density pass.  Counterpart of the dense path of
`summersph_tpu/ops/density.py`.

rho_i = sum_j m_j W(r_ij, h_i) over every column, with the self term
added by `pairs.finalize_density`, and with variable h the grad-h Omega.
It is exact, for small N, and is the brute-force oracle that the sorted
engine (`ops/cuda_pairs.py`) is held against.  `rows` receive the sums,
`cols` are the neighbour pool (the rows themselves by default); the
multi-device gather mode passes a rank's rows and the gathered columns.
Rows go in blocks of `utils.blocks.pick_block`, so that the [B, N_cols]
temporaries stay near `DENSE_BUDGET` elements each.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import Particles
from ..tracing import traced
from ..utils.blocks import pick_block, row_blocks, unblock
from . import pairs

# Pair elements per temporary of a row block (about ten temporaries).
DENSE_BUDGET = 1 << 22


def _dense_block(idx, rows: Particles, cx, cy, cz, cm, calive):
    """(rho_raw, omega_raw) of the rows `idx` [B] against all columns."""
    xi = rows.pos[idx]
    hi = rows.h[idx][:, None]
    return pairs.density_sums(xi[:, 0:1] - cx[None, :],
                              xi[:, 1:2] - cy[None, :],
                              xi[:, 2:3] - cz[None, :], hi, cm[None, :],
                              calive[None, :])


@traced("density")
def compute_density(rows: Particles, cfg: SimConfig,
                    cols: Particles | None = None) -> Particles:
    """`rows` with rho and Omega from a sum over every column; dead rows
    become inert (rho = 1, Omega = 1), and Omega is 1 with fixed h.  The
    JAX package's hashed cell grid (its `grid` argument) is not ported:
    the port runs `neighbor_mode='grid'` on the sorted engine."""
    cols = cols if cols is not None else rows
    cap = rows.capacity
    cx, cy, cz = cols.pos[:, 0], cols.pos[:, 1], cols.pos[:, 2]
    cm = torch.where(cols.alive, cols.mass, 0.0)
    blocks = row_blocks(cap, pick_block(cap, cols.capacity, DENSE_BUDGET),
                        rows.pos.device)
    sums = [_dense_block(idx, rows, cx, cy, cz, cm, cols.alive)
            for idx in blocks]
    rho = unblock(torch.stack([r for r, _ in sums]), cap)
    omega_raw = unblock(torch.stack([o for _, o in sums]), cap)
    rho, omega = pairs.finalize_density(rho, omega_raw, rows.h, rows.alive,
                                        rows.mass)
    if cfg.fixed_h is not None:
        omega = torch.ones_like(omega)
    return rows.replace(rho=rho, omega=omega)


__all__ = ["compute_density", "DENSE_BUDGET"]
