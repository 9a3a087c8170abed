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
   search of the group's key span (`group_windows`);
4. a candidate belongs to row i's offset-o stencil iff its key lies in row
   i's own range, which is what the pair kernels test.

The whole state is sorted with one stable `torch.sort` of the key and a
gather of every field by the permutation.  The JAX package sorts unstably,
so rows with equal keys may come out in another order: compare the two
packages per `pid`, never per slot.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import SimConfig
from ..state import Particles
from ..tracing import active, count, traced

WINDOW_BITS = 10
WINDOW = 1 << WINDOW_BITS                      # 1024 cells per axis
SENTINEL_KEY = 1 << 30                         # dead / invalid

KX = 1 << (2 * WINDOW_BITS)
KY = 1 << WINDOW_BITS

# (dx, dy) plane offsets; each covers dz in {-1, 0, 1} as one key range.
PLANE_OFFSETS = [dx * KX + dy * KY
                 for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

LANES = 128  # the padding granule (with cfg.sorted_block)

# cfg.neighbor_mode values this engine runs: 'grid' (the JAX package's
# hashed grid, a workaround for TPU gathers) sums the same pairs
SORTED_MODES = ("sorted", "grid")

# The headroom over h of the JAX package's hashed grid, which its
# h-iteration builds over h x 1.25 and whose half cell caps h there.
GRID_H_HEADROOM = 1.25


def sort_h_pad(cfg: SimConfig) -> float:
    """The cell headroom of a step's sort, whose half cell caps the
    h-iteration: none with fixed h; with variable h `cfg.sort_h_pad`, and
    under neighbor_mode='grid' GRID_H_HEADROOM, so that h is capped at
    min(max_length, 1.25 h_max) as on the JAX package's hashed grid."""
    if cfg.fixed_h is not None:
        return 1.0
    if cfg.neighbor_mode == "grid":
        return GRID_H_HEADROOM
    return cfg.sort_h_pad


@functools.cache
def _plane_offsets(device: torch.device) -> torch.Tensor:
    """PLANE_OFFSETS as an int32 tensor, made once per device: a tensor
    built from a Python list on every sort is a host-to-device copy from
    pageable memory, which makes the host wait for the card."""
    return torch.tensor(PLANE_OFFSETS, dtype=torch.int32, device=device)


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


@traced("sort")
def sort_particles(p: Particles, cfg: SimConfig, h_pad: float = 1.0,
                   carry_derived: bool = False, extra=None):
    """Sort the particles by cell key and find every group's 9 windows.

    Returns (sorted particles, padded with dead slots to a multiple of
    max(sorted_block, 128), grid), and as a third element `extra` in the
    sorted order when it is given: an [N] tensor that rides the sort, padded
    with 0 (the block-timestep rung).  Only the pair passes' inputs survive
    the sort; rho, P, cs, du, dalpha and acc come back zeroed and omega one,
    for the caller to recompute, as in the JAX package -- except with
    `carry_derived` (the block-timestep substep sort, blockstep.py), where
    they ride the sort too: inactive rows go on serving their last
    evaluation's rho/P/cs/omega to their active neighbours, and their
    carried acc/du/dalpha to their own later kicks.
    """
    B = cfg.sorted_block
    wg = cfg.window_group
    if B % wg or LANES % wg:
        raise ValueError(
            f"cfg.window_group ({wg}) must divide both cfg.sorted_block "
            f"({B}) and {LANES} so window groups tile the padded capacity")
    padded = _pad_to(p.capacity, max(B, LANES))
    if padded != p.capacity:
        if extra is not None:
            extra = torch.cat([extra, extra.new_zeros(padded - p.capacity)])
        p = _pad_particles(p, padded)
    cap = padded
    dtype = p.pos.dtype

    origin = torch.amin(torch.where(p.alive[:, None], p.pos, torch.inf),
                        dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    # 'grid' sizes its cell by h_max, as the JAX package's hashed grid
    # does, whatever cfg.cell_h_quantile says
    q = 1.0 if cfg.neighbor_mode == "grid" else cfg.cell_h_quantile
    if q >= 1.0:
        h_cell = torch.amax(torch.where(p.alive, p.h, 0.0))
    else:
        # quantile of live h: dead slots sort as 0 to the front
        hs = torch.sort(torch.where(p.alive, p.h, 0.0)).values
        n_live = torch.sum(p.alive).to(torch.int32)
        idx = (cap - n_live
               + (q * torch.clamp(n_live - 1, min=0).to(dtype))
               .to(torch.int32))
        # index_select: hs[idx] with a 0-d index reads idx on the host
        h_cell = torch.index_select(
            hs, 0, torch.clamp(idx, 0, cap - 1).reshape(1))[0]
    cell_size = torch.clamp(2.0 * h_cell * h_pad, min=1.0e-12)

    key = torch.where(p.alive, _cell_key(p.pos, origin, cell_size),
                      SENTINEL_KEY)
    raw = (p.pos - origin) / cell_size
    reach_over = p.alive & (2.0 * p.h * h_pad > cell_size)
    pos_over = p.alive & torch.any(raw >= WINDOW, dim=-1)
    n_clamped = torch.sum(pos_over | reach_over).to(torch.int32)

    key_s, perm = torch.sort(key, stable=True)
    if carry_derived:
        p_s = p.map(lambda a: a[perm]).replace(alive=key_s != SENTINEL_KEY)
    else:
        zero = torch.zeros(cap, dtype=dtype, device=p.pos.device)

        def gather(a):
            return None if a is None else a[perm]

        p_s = p.replace(
            pos=p.pos[perm], vel=p.vel[perm], acc=torch.zeros_like(p.pos),
            mass=p.mass[perm], u=p.u[perm], alpha=p.alpha[perm],
            h=p.h[perm], pid=p.pid[perm], u_c=gather(p.u_c),
            acc_ext=gather(p.acc_ext), alive=key_s != SENTINEL_KEY,
            omega=torch.ones_like(zero), rho=zero, pressure=zero, cs=zero,
            du=zero, dalpha=zero)

    starts, ends = group_windows(key_s, wg)
    if active():
        count("sph_candidates",
              torch.sum(ends - starts, dtype=torch.int64) * wg)
        count("sph_rows", torch.sum(p.alive))
    grid = SortedGrid(key=key_s, starts=starts, ends=ends, origin=origin,
                      cell_size=cell_size, n_clamped=n_clamped)
    if extra is not None:
        return p_s, grid, extra[perm]
    return p_s, grid


def group_windows(key_s: torch.Tensor, window_group: int,
                  key_rows: torch.Tensor = None):
    """(starts, ends), each int32 [G, 9]: the candidate range of every
    group of `window_group` consecutive rows of the sorted keys `key_s`
    (length a multiple of it) for each plane offset -- the keys in
    [kmin + off - 1, kmax + off + 1] of the group's key span, cut at the
    first dead (sentinel) row.  Both the SPH sort and the gravity sort
    (`pm_gravity.pm_short_range`) take their windows from here.  With
    `key_rows` (sorted, a multiple of window_group long) the groups are
    those rows', searched over the columns `key_s`: the slab
    decomposition's own rows against its rim-extended columns
    (`parallel.decomp.build_cols`)."""
    key_rows = key_s if key_rows is None else key_rows
    G = key_rows.shape[0] // window_group
    kmin = key_rows.view(G, window_group)[:, 0]
    kmax = key_rows.view(G, window_group)[:, -1]
    first_dead = torch.sum(key_s != SENTINEL_KEY).to(torch.int32)
    offs = _plane_offsets(key_s.device)
    lo = (kmin[:, None] + offs[None, :] - 1).contiguous()       # [G, 9]
    hi = (kmax[:, None] + offs[None, :] + 1).contiguous()
    starts = torch.searchsorted(key_s, lo, right=False, out_int32=True)
    ends = torch.searchsorted(key_s, hi, right=True, out_int32=True)
    return starts, torch.maximum(torch.minimum(ends, first_dead), starts)


def group_worklist(act: torch.Tensor, block: int):
    """(worklist [G] int32, count [1] int32) over row blocks of `block`
    rows: the blocks that hold an active row of `act` [N] bool, compacted
    to the front in ascending order (the rest follow), for the gated pair
    kernels.  The port's kernels own one window group a CUDA block, so
    its callers pass `cfg.window_group`.  Both stay on the device."""
    blk_act = torch.any(act.view(act.shape[0] // block, block), dim=1)
    work = torch.sort((~blk_act).to(torch.int8), stable=True).indices
    return (work.to(torch.int32),
            torch.sum(blk_act, dtype=torch.int32).reshape(1))


__all__ = ["SortedGrid", "sort_particles", "group_windows",
           "group_worklist", "PLANE_OFFSETS",
           "SENTINEL_KEY", "WINDOW", "WINDOW_BITS", "LANES", "SORTED_MODES",
           "GRID_H_HEADROOM", "sort_h_pad"]
