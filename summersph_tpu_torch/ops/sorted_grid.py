"""Sorted space-filling-curve neighbour structure.

Counterpart of `summersph_tpu/ops/sorted_grid.py`, whose docstring gives
the design:

1. particles are sorted by a packed linear cell key
   key = (cx << 20) | (cy << 10) | cz over a 1024^3 window of cells of side
   2 h_max anchored at the live minimum; dead particles carry
   `SENTINEL_KEY` and sort to the end;
2. in sorted order the neighbours of a cell at plane offset (dx, dy) are
   one contiguous key range of 3 z-cells, [key + off - 1, key + off + 1];
3. rows are grouped by `cfg.window_group` consecutive sorted particles, and
   each group's 9 candidate windows [starts, ends) are found by binary
   search of the group's key span;
4. a candidate belongs to row i's offset-o stencil iff its key lies in row
   i's own range, which is what the pair kernels test.

The whole state is sorted with one stable `torch.sort` of the key and a
gather of every field by the permutation.  The JAX package sorts unstably,
so rows with equal keys may come out in another order: compare the two
packages per `pid`, never per slot.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import SimConfig
from ..state import Particles

WINDOW_BITS = 10
WINDOW = 1 << WINDOW_BITS                      # 1024 cells per axis
SENTINEL_KEY = 1 << 30                         # dead / invalid

KX = 1 << (2 * WINDOW_BITS)
KY = 1 << WINDOW_BITS

# (dx, dy) plane offsets; each covers dz in {-1, 0, 1} as one key range.
PLANE_OFFSETS = [dx * KX + dy * KY
                 for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

LANES = 128  # the padding granule (with cfg.sorted_block)


@dataclasses.dataclass(frozen=True)
class SortedGrid:
    key: torch.Tensor        # [Np] int32 sorted cell keys (dead = sentinel)
    starts: torch.Tensor     # [G, 9] int32 window start, G = Np / window_group
    ends: torch.Tensor       # [G, 9] int32 window end (excl., <= first dead)
    origin: torch.Tensor     # [3]
    cell_size: torch.Tensor  # 0-d
    n_clamped: torch.Tensor  # live particles the key window cannot represent


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _cell_key(pos, origin, cell_size):
    c = torch.floor((pos - origin) / cell_size)
    c = torch.clamp(c, 0.0, WINDOW - 1).to(torch.int32)
    return ((c[..., 0] << (2 * WINDOW_BITS)) | (c[..., 1] << WINDOW_BITS)
            | c[..., 2])


def _pad_particles(p: Particles, padded: int) -> Particles:
    """Append dead slots (ids cap..padded-1) up to `padded` rows."""
    cap = p.capacity
    tail = Particles.zeros(padded - cap, p.pos.dtype, p.pos.device)
    tail = tail.replace(pid=tail.pid + cap)

    def cat(name):
        a = getattr(p, name)
        if a is None:
            return None
        b = getattr(tail, name)
        if b is None:  # optional carries pad with zeros
            b = torch.zeros((padded - cap,) + a.shape[1:], dtype=a.dtype,
                            device=a.device)
        return torch.cat([a, b])

    return p.replace(**{f.name: cat(f.name)
                        for f in dataclasses.fields(p)})


def sort_particles(p: Particles, cfg: SimConfig,
                   h_pad: float = 1.0) -> Tuple[Particles, SortedGrid]:
    """Sort the particles by cell key and find every group's 9 windows.

    Returns (sorted particles, padded with dead slots to a multiple of
    max(sorted_block, 128), grid).  Only the pair passes' inputs survive
    the sort; rho, P, cs, du, dalpha and acc come back zeroed and omega one,
    for the caller to recompute, as in the JAX package.
    """
    B = cfg.sorted_block
    wg = cfg.window_group
    if B % wg or LANES % wg:
        raise ValueError(
            f"cfg.window_group ({wg}) must divide both cfg.sorted_block "
            f"({B}) and {LANES} so window groups tile the padded capacity")
    padded = _pad_to(p.capacity, max(B, LANES))
    if padded != p.capacity:
        p = _pad_particles(p, padded)
    cap = padded
    dtype = p.pos.dtype

    origin = torch.amin(torch.where(p.alive[:, None], p.pos, torch.inf),
                        dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    q = cfg.cell_h_quantile
    if q >= 1.0:
        h_cell = torch.amax(torch.where(p.alive, p.h, 0.0))
    else:
        # quantile of live h: dead slots sort as 0 to the front
        hs = torch.sort(torch.where(p.alive, p.h, 0.0)).values
        n_live = torch.sum(p.alive).to(torch.int32)
        idx = (cap - n_live
               + (q * torch.clamp(n_live - 1, min=0).to(dtype))
               .to(torch.int32))
        h_cell = hs[torch.clamp(idx, 0, cap - 1)]
    cell_size = torch.clamp(2.0 * h_cell * h_pad, min=1.0e-12)

    key = torch.where(p.alive, _cell_key(p.pos, origin, cell_size),
                      SENTINEL_KEY)
    raw = (p.pos - origin) / cell_size
    reach_over = p.alive & (2.0 * p.h * h_pad > cell_size)
    pos_over = p.alive & torch.any(raw >= WINDOW, dim=-1)
    n_clamped = torch.sum(pos_over | reach_over).to(torch.int32)

    key_s, perm = torch.sort(key, stable=True)
    zero = torch.zeros(cap, dtype=dtype, device=p.pos.device)

    def gather(a):
        return None if a is None else a[perm]

    p_s = p.replace(
        pos=p.pos[perm], vel=p.vel[perm], acc=torch.zeros_like(p.pos),
        mass=p.mass[perm], u=p.u[perm], alpha=p.alpha[perm], h=p.h[perm],
        pid=p.pid[perm], u_c=gather(p.u_c), acc_ext=gather(p.acc_ext),
        alive=key_s != SENTINEL_KEY, omega=torch.ones_like(zero),
        rho=zero, pressure=zero, cs=zero, du=zero, dalpha=zero)

    G = cap // wg
    kmin = key_s.view(G, wg)[:, 0]
    kmax = key_s.view(G, wg)[:, -1]
    first_dead = torch.sum(key_s != SENTINEL_KEY).to(torch.int32)
    offs = torch.tensor(PLANE_OFFSETS, dtype=torch.int32,
                        device=key_s.device)
    lo = (kmin[:, None] + offs[None, :] - 1).contiguous()       # [G, 9]
    hi = (kmax[:, None] + offs[None, :] + 1).contiguous()
    starts = torch.searchsorted(key_s, lo, right=False, out_int32=True)
    ends = torch.searchsorted(key_s, hi, right=True, out_int32=True)
    ends = torch.maximum(torch.minimum(ends, first_dead), starts)

    grid = SortedGrid(key=key_s, starts=starts, ends=ends, origin=origin,
                      cell_size=cell_size, n_clamped=n_clamped)
    return p_s, grid


__all__ = ["SortedGrid", "sort_particles", "PLANE_OFFSETS", "SENTINEL_KEY",
           "WINDOW", "WINDOW_BITS", "LANES"]
