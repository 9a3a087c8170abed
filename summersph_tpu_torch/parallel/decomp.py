"""The slab decomposition (`cfg.decomp='slab'`) over `torch.distributed`:
per-rank memory and traffic O(N/D + rim), not O(N).  Counterpart of
`summersph_tpu/parallel/decomp.py`, whose docstring gives the design:

* **Ownership = contiguous slabs of the global space-filling-curve order.**
  Rank d owns a key interval of the global sorted order; everything its
  rows can reach through the +-1-cell stencil lives near its slab's
  edges, in the rim.
* **Redistribution by sampled splitters** (`redistribute`): each rank
  sorts its rows by (key, pid), takes a midpoint-stratified sample of its
  live keys, and the gathered samples' weighted quantiles are the D - 1
  splitters.  The migrants go in one all-to-all of one packed [F, D x
  migrate_rows] buffer, and are merged with one sort.  A chunk
  that outgrows migrate_rows keeps its surplus home (mis-owned, never
  lost), and a slab that outgrows its capacity drops its last rows; both
  are counted (`decomp_pressure`).
* **Rim exchange** (`exchange_rim`): the first and last `halo` live rows
  of a slab are the rims its rank neighbours need; `hops` shifts each way
  build [left rim | own | right rim] (`build_cols`), sorted by (key, pid)
  for the window machinery, whose windows are the own row groups'
  searched over the column keys (`sorted_grid.group_windows` with
  `key_rows`).  An own row whose stencil reaches past a rim that was cut
  short is counted (`rim_short_count`).

Every sort here is one `torch.sort` of the int64 composite key << 32 |
pid, a total order over the live rows (pids are unique and >= 0), so
`attach_density` reproduces `build_cols`' permutation exactly without
relying on a stable sort.  Dead rows sort last (the sentinel key) and may
permute among themselves; nothing reads them.

The grid geometry (`global_geometry`) is the same on every rank: the
origin and h_max from collectives, and with `cfg.cell_h_quantile < 1` the
quantile from a summed 256-bin histogram rounded up to its bin's upper
edge, with the JAX package's truncating int32 casts -- not the exact
quantile of `sorted_grid.sort_particles`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SimConfig
from ..ops.sorted_grid import (KX, KY, SENTINEL_KEY, SortedGrid, _cell_key,
                               group_windows)
from ..state import Particles
from ..tracing import traced
from .comm import (Mesh, all_gather_tiled, all_to_all_tiled, pack_fields,
                   pmax, pmin, ppermute, psum, unpack_fields)

# The fields that ride the redistribution, after the key and pid (the
# JAX package's `_RIDE_FIELDS` follow pos and vel; u_c rides last when
# present), and those of the rims the pair passes read.
_RIDE_FIELDS = ("mass", "u", "alpha", "h")
RIM_FIELDS = ("pid", "pos", "vel", "mass", "alpha", "h")


@dataclasses.dataclass(frozen=True)
class DecompAux:
    """What a step's force evaluation hands its epilogue under the slab
    decomposition: the local grid (column keys, the own row groups'
    windows), the sorted rim-extended columns, the own rows' keys (the
    h-iteration re-sums against the same columns and windows), and the
    step's capacity pressure events (int32, the `decomp_pressure` slot)."""

    grid: SortedGrid
    cols: Particles
    key_rows: torch.Tensor
    pressure: torch.Tensor


def _int0(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def global_geometry(p: Particles, cfg: SimConfig, mesh: Mesh,
                    h_pad: float = 1.0):
    """(origin [3], cell_size 0-d): the global grid geometry, the same on
    every rank.  cell = 2 h_pad h_cell, h_cell = h_max over the live
    particles, or with cfg.cell_h_quantile = q < 1 the upper edge of the
    bin of a summed 256-bin histogram of live h (between the global live h
    extremes) where the cumulative count first reaches int32(q n_live)."""
    alive3 = p.alive[:, None]
    lo = torch.amin(torch.where(alive3, p.pos, torch.inf), dim=0)
    origin = pmin(lo, mesh)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)

    h_live = torch.where(p.alive, p.h, 0.0)
    h_max = pmax(torch.amax(h_live), mesh)
    q = cfg.cell_h_quantile
    if q >= 1.0:
        h_cell = h_max
    else:
        h_min = pmin(torch.amin(torch.where(p.alive, p.h, torch.inf)), mesh)
        h_min = torch.where(torch.isfinite(h_min), h_min, 0.0)
        nbins = 256
        width = torch.clamp(h_max - h_min, min=1.0e-12)
        # truncating casts, as the JAX package's astype(int32)
        idx = torch.clamp(_int0((h_live - h_min) / width * nbins), 0,
                          nbins - 1)
        hist = torch.zeros(nbins, dtype=torch.int32, device=p.pos.device)
        hist.index_add_(0, idx, _int0(p.alive))
        hist = psum(hist, mesh)
        n_live = torch.sum(hist)
        csum = torch.cumsum(hist, dim=0)
        target = _int0(q * n_live.to(p.pos.dtype))
        bin_i = torch.argmax(_int0(csum >= torch.clamp(target, min=1)))
        h_cell = h_min + (bin_i + 1).to(p.pos.dtype) / nbins * width
        h_cell = torch.minimum(h_cell, h_max)
    cell_size = torch.clamp(2.0 * h_cell * h_pad, min=1.0e-12)
    return origin, cell_size


def _key_pid_order(key: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by (key, pid): one sort of the
    int64 composite key << 32 | pid."""
    comp = (key.to(torch.int64) << 32) | pid.to(torch.int64)
    return torch.sort(comp).indices


def _ride(p: Particles):
    """The fields that ride a redistribution, in the bundle's order."""
    fields = [p.pid, p.pos, p.vel] + [getattr(p, f) for f in _RIDE_FIELDS]
    return fields + ([p.u_c] if p.u_c is not None else [])


def _unbundle(p: Particles, key_s: torch.Tensor, fields) -> Particles:
    """A Particles of the sorted ride fields, the derived fields zeroed as
    `sorted_grid.sort_particles` zeroes them and omega one."""
    pid, pos, vel = fields[:3]
    rest = dict(zip(_RIDE_FIELDS, fields[3:3 + len(_RIDE_FIELDS)]))
    u_c = fields[-1] if p.u_c is not None else None
    zero = torch.zeros_like(key_s, dtype=pos.dtype)
    return p.replace(
        pos=pos, vel=vel, acc=torch.zeros_like(pos), pid=pid,
        alive=key_s != SENTINEL_KEY, u_c=u_c, acc_ext=None,
        omega=torch.ones_like(zero), rho=zero, pressure=zero, cs=zero,
        du=zero, dalpha=zero, **rest)


@traced("redistribute")
def redistribute(p: Particles, cfg: SimConfig, mesh: Mesh, origin,
                 cell_size):
    """Re-own the particles by slabs of the global key order.  Returns
    (key_own [nloc], p_own, splitters [D - 1], n_misowned, n_slab_overflow):
    the own slab sorted by (key, pid), dead rows (sentinel keys) last."""
    D, me, nloc = mesh.size, mesh.rank, p.capacity
    C = min(cfg.migrate_rows, nloc)
    dev = p.pos.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    key = torch.where(p.alive, _cell_key(p.pos, origin, cell_size),
                      SENTINEL_KEY)
    order = _key_pid_order(key, p.pid)
    key_s = key[order]
    fields = [f[order] for f in _ride(p)]
    n_live = _int0(torch.sum(key_s != SENTINEL_KEY))
    if D == 1:
        return (key_s, _unbundle(p, key_s, fields),
                torch.zeros(0, dtype=torch.int32, device=dev), zero, zero)

    # splitters: a midpoint-stratified sample of each rank's live prefix,
    # weighted by its live count, and the weighted (j + 1) / D quantiles
    S = cfg.decomp_samples
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    samp_idx = torch.minimum(((2 * ar + 1) * n_live) // (2 * S),
                             torch.clamp(n_live - 1, min=0))
    samples = torch.where(n_live > 0, key_s[samp_idx.long()], SENTINEL_KEY)
    weights = torch.clamp((n_live + S - 1) // S, min=1).expand(S)
    all_samp, all_w = all_gather_tiled(
        torch.stack([samples, weights.to(torch.int32)]), mesh, dim=1)
    all_w = torch.where(all_samp == SENTINEL_KEY, 0, all_w)
    all_samp, perm = torch.sort(all_samp, stable=True)
    cumw = torch.cumsum(all_w[perm], dim=0, dtype=torch.int32)
    targets = (torch.arange(1, D, dtype=torch.int32, device=dev)
               * cumw[-1]) // D
    idx = torch.searchsorted(cumw, targets, right=True)
    splitters = all_samp[torch.clamp(idx, 0, D * S - 1)]

    # rows [b[j], b[j + 1]) of my sorted order belong to slab j
    bounds = torch.searchsorted(key_s, splitters, right=False,
                                out_int32=True)
    bounds = torch.minimum(bounds, n_live)
    b_full = torch.cat([zero[None], bounds, n_live[None]])
    counts = b_full[1:] - b_full[:-1]
    not_me = torch.arange(D, device=dev) != me
    n_misowned = _int0(torch.sum(torch.where(
        not_me, torch.clamp(counts - C, min=0), 0)))

    # C rows to each other slab (my own chunk masked dead: it stays);
    # rows beyond C stay home, mis-owned and counted
    k = torch.arange(C, dtype=torch.int32, device=dev)
    start = torch.clamp(b_full[:-1], 0, nloc - C)                 # [D]
    rows = start[:, None] + k[None, :]                            # [D, C]
    valid = ((rows >= b_full[:-1, None])
             & (rows < (b_full[:-1] + counts)[:, None]) & not_me[:, None])
    flat = rows.reshape(-1).long()
    send_key = torch.where(valid.reshape(-1), key_s[flat], SENTINEL_KEY)
    # (index_add_, not a boolean index: the host never waits for a count)
    sent = torch.zeros(nloc, dtype=torch.int32, device=dev).index_add_(
        0, flat, _int0(valid.reshape(-1))) > 0
    like = [key_s] + fields
    buf = pack_fields([send_key] + [f[flat] for f in fields])
    recv = unpack_fields(all_to_all_tiled(buf, mesh, 1, 1), like)

    # merge: the rows kept home (those sent masked dead) and the received
    key_m = torch.cat([torch.where(sent, SENTINEL_KEY, key_s), recv[0]])
    merged = [torch.cat([f, r]) for f, r in zip(fields, recv[1:])]
    order = _key_pid_order(key_m, merged[0])[:nloc]
    n_slab_overflow = torch.clamp(
        _int0(torch.sum(key_m != SENTINEL_KEY)) - nloc, min=0)
    key_own = key_m[order]
    p_own = _unbundle(p, key_own, [f[order] for f in merged])
    return key_own, p_own, splitters, n_misowned, n_slab_overflow


@traced("exchange_rim")
def exchange_rim(key_own, p_own: Particles, mesh: Mesh, halo: int,
                 fields=("pos", "vel", "mass", "alpha", "h", "pid"),
                 hops: int = 1):
    """(rim_left, rim_right): each a dict {"key", <fields>..., "truncated"}
    of hops x halo rows -- the `halo` boundary rows of each of the `hops`
    nearest rank neighbours on that side, the farthest hop first (the left
    rim's keys rise toward the own slab).  A missing source (past an edge
    rank) arrives as zeros with sentinel keys.  Coverage stays contiguous:
    once a hop's neighbour holds more live rows than `halo` (a hole in its
    middle), every farther hop is masked dead, and "truncated" (a 0-d
    bool) says whether live rows exist on that side beyond what the rim
    delivered, from the gathered live counts.  With D = 1 (no hops) each
    rim is max(halo, 1) dead rows.  Deterministic in (key_own, the alive
    rows, halo, hops): `attach_density` relies on it."""
    D, me, nloc = mesh.size, mesh.rank, p_own.capacity
    dev = key_own.device
    if halo > nloc:
        raise ValueError(f"exchange_rim: halo {halo} exceeds the slab's "
                         f"{nloc} rows")
    like = [key_own] + [getattr(p_own, f) for f in fields]
    hops = min(hops, D - 1) if D > 1 else 0
    if hops == 0:
        n = max(halo, 1)
        dead = {"key": torch.full((n,), SENTINEL_KEY, dtype=torch.int32,
                                  device=dev),
                "truncated": torch.zeros((), dtype=torch.bool, device=dev)}
        for f, a in zip(fields, like[1:]):
            dead[f] = (torch.ones if f == "h" else torch.zeros)(
                (n,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        return dead, dict(dead)
    n_live = _int0(torch.sum(key_own != SENTINEL_KEY))
    counts = all_gather_tiled(n_live[None], mesh)                # [D]
    k = torch.arange(halo, device=dev)

    def take(start):
        rows = start + k
        return pack_fields([a[rows] for a in like])

    lo_src = take(0)                                      # my first rows
    hi_src = take(torch.clamp(n_live - halo, 0, nloc - halo))  # last live

    def side(src_buf, sign):
        parts = []
        delivered = torch.zeros((), dtype=torch.int32, device=dev)
        blocked = torch.zeros((), dtype=torch.bool, device=dev)
        for s in range(1, hops + 1):
            rim = unpack_fields(ppermute(src_buf, mesh, sign * s), like)
            src = me - sign * s
            if 0 <= src < D:
                valid, n_src = ~blocked, counts[src]
            else:
                valid, n_src = torch.zeros_like(blocked), counts[0] * 0
            rim[0] = torch.where(valid, rim[0], SENTINEL_KEY)
            parts.append(rim)
            delivered = delivered + torch.where(
                valid, torch.clamp(n_src, max=halo), 0)
            blocked = blocked | (valid & (n_src > halo))
        ranks = torch.arange(D, device=dev)
        on_side = ranks < me if sign > 0 else ranks > me
        total = torch.sum(torch.where(on_side, counts, 0))
        cat = [torch.cat([part[c] for part in reversed(parts)])
               for c in range(len(like))]
        out = dict(zip(("key",) + tuple(fields), cat))
        out["truncated"] = total > delivered
        return out

    return side(hi_src, +1), side(lo_src, -1)


def rim_short_count(key_rows, rim_left, rim_right, reach_lo, reach_hi):
    """Own live rows whose stencil key range [reach_lo, reach_hi] runs
    past the farthest key of a rim that was truncated (int32 0-d)."""
    live = key_rows != SENTINEL_KEY
    left_min = torch.amin(torch.where(rim_left["key"] != SENTINEL_KEY,
                                      rim_left["key"], SENTINEL_KEY))
    right_max = torch.amax(torch.where(rim_right["key"] != SENTINEL_KEY,
                                       rim_right["key"], -1))
    short_l = rim_left["truncated"] & live & (reach_lo < left_min)
    short_r = rim_right["truncated"] & live & (reach_hi > right_max)
    return _int0(torch.sum(short_l | short_r))


def _with_rims(rim_l, own: dict, rim_r, name):
    return torch.cat([rim_l[name], own[name], rim_r[name]])


def build_cols(key_own, p_own: Particles, rim_l, rim_r, cfg: SimConfig,
               origin, cell_size, h_pad: float):
    """The local columns and grid of the own rows.  Returns (p_cols, grid,
    rim_short): p_cols is [left rim | own | right rim] sorted by (key,
    pid), h 1 on dead rows (a 0 there NaNs the masked lanes of the plain
    versions), u, rho, P, cs, du, dalpha and acc zeroed and omega one
    (`attach_density` brings the density fields); grid.key the column
    keys, grid.starts/ends the own row groups' windows into the columns,
    cell_size the global cell, n_clamped the own live rows whose 2 h h_pad
    outreaches the cell; rim_short the own rows whose +-1-cell stencil
    outreaches a truncated rim."""
    own = {"key": key_own, **{f: getattr(p_own, f) for f in RIM_FIELDS}}
    key_c = _with_rims(rim_l, own, rim_r, "key")
    cols = {f: _with_rims(rim_l, own, rim_r, f) for f in RIM_FIELDS}
    order = _key_pid_order(key_c, cols["pid"])
    key_cs = key_c[order]
    alive_c = key_cs != SENTINEL_KEY
    nc = key_cs.shape[0]
    dtype, dev = p_own.pos.dtype, p_own.pos.device
    zero = torch.zeros(nc, dtype=dtype, device=dev)
    p_cols = Particles(
        pos=cols["pos"][order], vel=cols["vel"][order],
        acc=torch.zeros((nc, 3), dtype=dtype, device=dev),
        mass=cols["mass"][order], u=zero, rho=zero, pressure=zero, cs=zero,
        du=zero, alpha=cols["alpha"][order], dalpha=zero,
        h=torch.where(alive_c, cols["h"][order], 1.0),
        omega=torch.ones_like(zero), alive=alive_c, pid=cols["pid"][order],
        u_c=None if p_own.u_c is None else zero)

    starts, ends = group_windows(key_cs, cfg.window_group, key_rows=key_own)
    n_clamped = _int0(torch.sum(p_own.alive
                                & (2.0 * p_own.h * h_pad > cell_size)))
    rim_short = rim_short_count(key_own, rim_l, rim_r,
                                key_own - (KX + KY + 1),
                                key_own + (KX + KY + 1))
    grid = SortedGrid(key=key_cs, starts=starts, ends=ends, origin=origin,
                      cell_size=cell_size, n_clamped=n_clamped)
    return p_cols, grid, rim_short


def _attach(key_own, p_own: Particles, p_cols: Particles, rim_l, rim_r,
            names) -> Particles:
    """p_cols with the fields `names` of the own rows and the rims (which
    carry pid and those fields), sorted by (key, pid) as `build_cols`
    sorts the columns."""
    own = {"key": key_own, "pid": p_own.pid,
           **{f: getattr(p_own, f) for f in names}}
    order = _key_pid_order(_with_rims(rim_l, own, rim_r, "key"),
                           _with_rims(rim_l, own, rim_r, "pid"))
    return p_cols.replace(**{f: _with_rims(rim_l, own, rim_r, f)[order]
                             for f in names})


_DENSITY_FIELDS = ("rho", "pressure", "cs", "omega")


def attach_density(key_own, p_own: Particles, p_cols: Particles,
                   mesh: Mesh, cfg: SimConfig) -> Particles:
    """p_cols with the own rows' and the rims' fresh rho, P, cs and omega:
    the same rim exchange as the step's columns (cfg.halo_rows,
    cfg.halo_hops) and the same (key, pid) sort, so the same permutation
    over the live rows."""
    rim_l, rim_r = exchange_rim(key_own, p_own, mesh, cfg.halo_rows,
                                fields=("pid",) + _DENSITY_FIELDS,
                                hops=cfg.halo_hops)
    return _attach(key_own, p_own, p_cols, rim_l, rim_r, _DENSITY_FIELDS)


def slabs_in_process(p: Particles, grid: SortedGrid, cfg: SimConfig,
                     n_slabs: int, halo: int, h_pad: float = 1.0):
    """The local sets that n_slabs ranks holding the n_slabs equal slabs
    of the sorted set `p` (keys grid.key) would build, made in one process
    with no collective, to hold the key_rows passes against the whole set:
    for each slab, (key_own, p_own, p_cols, local grid, rim_short), its
    rims the `halo` sorted rows on each side (dead past either end),
    p_cols carrying p's rho, P, cs and omega."""
    n = p.capacity
    nl = n // n_slabs
    live = grid.key != SENTINEL_KEY
    names = RIM_FIELDS + _DENSITY_FIELDS

    def rim(lo, hi):
        idx = torch.arange(lo, hi, device=p.pos.device)
        ok = (idx >= 0) & (idx < n)
        idx = torch.clamp(idx, 0, n - 1)
        out = {"key": torch.where(ok, grid.key[idx], SENTINEL_KEY)}
        for f in names:
            a = getattr(p, f)[idx]
            out[f] = torch.where(ok.view((-1,) + (1,) * (a.dim() - 1)), a,
                                 torch.zeros_like(a))
        return out

    out = []
    for d in range(n_slabs):
        lo, hi = d * nl, (d + 1) * nl
        key_own, p_own = grid.key[lo:hi], p.map(lambda a: a[lo:hi])
        rim_l, rim_r = rim(lo - halo, lo), rim(hi, hi + halo)
        rim_l["truncated"] = torch.any(live[:max(lo - halo, 0)])
        rim_r["truncated"] = torch.any(live[min(hi + halo, n):])
        p_cols, lgrid, short = build_cols(key_own, p_own, rim_l, rim_r, cfg,
                                          grid.origin, grid.cell_size, h_pad)
        p_cols = _attach(key_own, p_own, p_cols, rim_l, rim_r,
                         _DENSITY_FIELDS)
        out.append((key_own, p_own, p_cols, lgrid, short))
    return out


__all__ = ["DecompAux", "global_geometry", "redistribute", "exchange_rim",
           "build_cols", "attach_density", "rim_short_count",
           "slabs_in_process", "RIM_FIELDS", "KX", "KY"]
