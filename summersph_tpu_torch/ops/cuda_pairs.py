"""Pair passes on the sorted windows: CUDA kernels and their plain
PyTorch versions.  Counterpart of `summersph_tpu/ops/pallas_pairs.py`.

`density_sums`, `force_sums` and `grav_short_sums` dispatch by device: a
tensor on the CPU takes the plain version (`density_sums_plain`,
`force_sums_plain`, `grav_short_sums_plain`), a tensor on a CUDA card
launches the hand-written kernel (`csrc/sph_pairs.cu`) or raises.  There
is no fallback from a kernel to its plain version.  The SPH passes also
dispatch on `cfg.fixed_h`: fixed h launches `density_fixed_h` and
`force_fixed_h` (`force_fixed_h_grav` with `grav_split`), variable h
(`fixed_h=None`) their grad-h forms `density_var_h` and `force_var_h`
(`force_var_h_grav`).  Each wrapper counts its kernel launches in plain
integer attributes, one per kernel: `density_sums.launches`
(`density_fixed_h`), `density_sums.var_launches` (`density_var_h`),
`force_sums.launches`, `force_sums.fused_launches`,
`force_sums.var_launches`, `force_sums.var_fused_launches` and
`grav_short_sums.launches`.

Block timesteps gate the passes by row: with `active` = (worklist [G]
int32, count [1] int32) from `sorted_grid.group_worklist` only the window
groups worklist[:count] are computed, by the `_gated` form of the same
kernel (counted apart: `gated_launches`, `var_gated_launches`,
`fused_gated_launches`, `var_fused_gated_launches`), which reads the count
on the device.  Rows of the other groups come back 0.  Columns are never
gated: an active row sums over all its candidates.

Both versions compute the same sums over the same ranges: for every
window group of `cfg.window_group` sorted rows and each of the 9 plane
offsets, every candidate in the group's true [starts, ends), under each
row's exact key mask.  The TPU kernels' DMA layout (128-lane aligned
fetches, 3-bit packed plans, exact-window rotations, double buffering)
has no counterpart: it exists for Mosaic, and walking the true ranges
computes what it computes.  Because nothing is capped, `window_overflow`
is 0.

Every kernel tests each candidate of a row's windows with one 16-byte
load (x, y, z and the key's bits, `pack_geometry`) and runs the pair
arithmetic on the survivors only.  The density and gravity kernels stage
the masked mass beside those records; the force kernels read the other
fields from one record per particle, which `pack_force` forms once per
force launch: on the card with the `pack_force` kernel (counted in
`pack_force.launches`), on the CPU, where nothing needs them, as its plain
version `pack_force_plain`.

The gravity split (r_s, r_cut) of a step is a pair of 0-d tensors; the
kernels read it from a two-float device buffer, so no wrapper waits for
the card.  The kernels take float32 only, as the TPU kernels do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import SimConfig
from ..state import Particles
from ..utils import build
from ..utils.units import G, PI
from . import pairs
from .eos import eos_update
from .kernels import dw_shape, w_shape
from .sorted_grid import PLANE_OFFSETS, SortedGrid

SOURCE = "summersph_tpu_torch/csrc/sph_pairs.cu"

# Pair elements per chunk of window groups in the plain versions, which
# bounds their memory (about 30 temporaries of this many elements).
PAIR_BUDGET = 1 << 23


def _on_cpu(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its plain version: only for a CPU tensor."""
    return t.device.type == "cpu"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("sph_pairs")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, n_ptr, tail in (
            ("density_fixed_h", 6, [i32, i32, ptr]),
            ("density_var_h", 7, [i32, i32, ptr]),
            ("force_fixed_h", 13, [i32, i32, f32, f32, ptr]),
            ("force_var_h", 13, [i32, i32, f32, f32, ptr]),
            ("force_fixed_h_grav", 17, [i32, i32, f32, f32, ptr]),
            ("force_var_h_grav", 17, [i32, i32, f32, f32, ptr]),
            ("grav_short", 9, [i32, i32, ptr])):
        # the gated form: two more pointers, worklist and count
        for fn, k in ((getattr(lib, name), n_ptr),
                      (getattr(lib, name + "_gated"), n_ptr + 2)):
            fn.argtypes = [ptr] * k + tail
            fn.restype = i32
    lib.pack_force.argtypes = [ptr] * 14 + [i32, i32, ptr]
    lib.pack_force.restype = i32
    return lib


def _check_cuda_inputs(n: int, groups: int, floats, ints, grid: SortedGrid,
                       packed=()):
    """Raise on what the kernels do not take.  The fields named in `packed`
    reach a kernel through a pack, which copies them, and need not be
    contiguous; every other one is passed by its pointer."""
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"CUDA pair kernels take float32 only; {name} "
                            f"is {t.dtype}")
    for name, t in {**floats, **ints}.items():
        if (not t.is_cuda or t.shape != (n,)
                or not (name in packed or t.is_contiguous())):
            raise ValueError(f"{name}: expected a contiguous CUDA tensor of "
                             f"shape ({n},), got {tuple(t.shape)} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    for name in ("starts", "ends"):
        t = getattr(grid, name)
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != (groups, 9) or t.device != grid.key.device):
            raise ValueError(f"grid.{name}: expected contiguous int32 "
                             f"[{groups}, 9], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if ints["key"].dtype != torch.int32:
        raise TypeError("grid.key must be int32")


def _gate_pointers(active, groups: int, device):
    """The (worklist, count) device pointers of a gated launch, after
    checking what the kernel relies on: int32, contiguous, on `device`,
    one worklist entry per window group."""
    work, count = active
    for name, t, shape in (("worklist", work, (groups,)),
                           ("count", count, (1,))):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != shape or t.device != device):
            raise ValueError(f"active {name}: expected contiguous int32 "
                             f"{shape} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return work.data_ptr(), count.data_ptr()


def _launch(fn, *args):
    """Call a C entry point and raise on its cudaGetLastError().  Kernels
    run on PyTorch's current stream, so the temporaries the wrappers pass
    may be freed on return: the caching allocator reuses their memory only
    for work ordered after the kernel on that stream."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def pack_geometry(pos: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """[N, 4] int32 records (the bits of x, y, z, then the cell key): the
    one 16-byte load per candidate of the pair kernels' candidate test.  Integer copies only, so any int32 key keeps its bits
    (the TPU pack, pallas_pairs.py:78-104, carried the key's bits in a
    float row for its own reasons)."""
    return torch.cat([pos.contiguous().view(torch.int32), key[:, None]],
                     dim=1)


def pack_force_plain(p: Particles, key: torch.Tensor, var: bool):
    """Plain PyTorch version of the `pack_force` kernel: the per-particle
    records of the force kernels.  Returns (geo, attr, sup2): geo [N, 4]
    int32 (`pack_geometry`); attr [N, 8] = (vx, vy, vz, m, pterm, rho, cs,
    alpha) with m = 0 on dead rows and pterm = P / max(Omega rho^2, 1e-30),
    one 32-byte record a particle; with `var` attr is [N, 16], continued by
    (h, 1 / h, 1 / (pi h^4), 4 h^2) and four zeros, and sup2 = 4 h^2 [N]
    (staged beside the candidates); else sup2 is None."""
    m = torch.where(p.alive, p.mass, 0.0)
    pterm = p.pressure / torch.clamp(p.omega * p.rho * p.rho, min=1.0e-30)
    cols = [p.vel, torch.stack([m, pterm, p.rho, p.cs, p.alpha], dim=1)]
    sup2 = None
    if var:
        inv_h = 1.0 / p.h
        sup2 = 4.0 * p.h * p.h
        cols += [torch.stack([p.h, inv_h, ((1.0 / PI) * inv_h * inv_h)
                              * (inv_h * inv_h), sup2], dim=1),
                 torch.zeros_like(p.pos[:, :1]).expand(-1, 4)]
    return pack_geometry(p.pos, key), torch.cat(cols, dim=1), sup2


def pack_force(p: Particles, key: torch.Tensor, var: bool):
    """(geo, attr, sup2) of `pack_force_plain`, formed once per launch of a
    force kernel from the sorted particles and their keys.  CPU: the plain
    version; CUDA: the `pack_force` kernel, one pass over the particles
    that reads nothing on the host."""
    if _on_cpu(p.pos):
        return pack_force_plain(p, key, var)
    n = p.capacity
    fields = [p.pos, p.vel, p.mass, p.alive, p.h, key, p.pressure, p.rho,
              p.omega, p.cs, p.alpha]
    for t in fields:
        if not t.is_cuda or t.shape[0] != n:
            raise ValueError(f"pack_force: expected CUDA tensors of {n} rows, "
                             f"got {tuple(t.shape)} on {t.device}")
    if (p.alive.dtype != torch.bool or key.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in fields
                   if t.is_floating_point())):
        raise TypeError("pack_force takes float32 fields, a bool alive and "
                        "an int32 key")
    fields = [t.contiguous() for t in fields]
    dev = p.pos.device
    geo = torch.empty((n, 4), dtype=torch.int32, device=dev)
    attr = torch.empty((n, 16 if var else 8), dtype=torch.float32, device=dev)
    sup2 = torch.empty(n, dtype=torch.float32, device=dev) if var else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch(_library().pack_force, *(t.data_ptr() for t in fields),
            geo.data_ptr(), attr.data_ptr(),
            sup2.data_ptr() if var else None, n, int(var), stream)
    pack_force.launches += 1
    return geo, attr, sup2


def _split_buffer(grav_split, device) -> torch.Tensor:
    """The float32 device buffer {r_s, r_cut} the gravity kernels read."""
    return torch.stack([torch.as_tensor(v, device=device)
                        for v in grav_split]).to(torch.float32).contiguous()


def _groups(n: int, cfg: SimConfig, grid: SortedGrid) -> int:
    wg = cfg.window_group
    if n % wg or grid.starts.shape[0] != n // wg:
        raise ValueError(f"{n} rows do not tile into window groups of {wg} "
                         f"matching grid.starts {tuple(grid.starts.shape)}")
    return n // wg


# --------------------------------------------------------------- density

def density_sums(p: Particles, cfg: SimConfig, grid: SortedGrid,
                 active=None):
    """(rho_raw, omega_raw), each [N]: rho_raw = sum_j m_j W(r_ij, h_i)
    over the windows, self excluded (pairs.finalize_density adds it), and
    with variable h the grad-h sum omega_raw = sum_j m_j dW/dh(r_ij, h_i);
    with fixed h omega_raw is zero, as `pallas_density_sums` returns it.
    With `active` = (worklist, count) only the listed window groups, 0 on
    the rest.  CPU: the plain version; CUDA: the `density_fixed_h` kernel,
    or `density_var_h` when cfg.fixed_h is None, or with `active` their
    `_gated` forms."""
    if _on_cpu(p.pos):
        return density_sums_plain(p, cfg, grid, active)
    n = p.capacity
    groups = _groups(n, cfg, grid)
    # dead particles carry mass 0, as in the TPU pack
    m = torch.where(p.alive, p.mass, 0.0)
    h = p.h.contiguous()
    _check_cuda_inputs(n, groups, {"x": p.pos[:, 0], "m": m, "h": h},
                       {"key": grid.key}, grid, packed=("x",))
    geo = pack_geometry(p.pos, grid.key)
    gated = active is not None
    gate = _gate_pointers(active, groups, p.pos.device) if gated else ()
    var = cfg.fixed_h is None
    # a gated kernel leaves unlisted rows unwritten: they must read 0
    outs = (torch.zeros if gated or not var else torch.empty)(
        (2, n), dtype=torch.float32, device=p.pos.device)
    stream = torch.cuda.current_stream(p.pos.device).cuda_stream
    name = ("density_var_h" if var else "density_fixed_h") + (
        "_gated" if gated else "")
    _launch(getattr(_library(), name),
            geo.data_ptr(), m.data_ptr(), h.data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(),
            *(outs[c].data_ptr() for c in range(2 if var else 1)), *gate,
            n, cfg.window_group, stream)
    _count(density_sums, var, False, gated)
    return outs[0], outs[1]


def _count(wrapper, var: bool, fused: bool, gated: bool):
    """Add one to the launch count of the kernel a wrapper just launched:
    `launches`, with `var_`, `fused_` and `gated_` in that order for the
    variable-h, fused-gravity and gated forms."""
    name = (("var_" if var else "") + ("fused_" if fused else "")
            + ("gated_" if gated else "") + "launches")
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def launch_counters():
    """(wrapper, attribute) of every launch count, one per CUDA kernel."""
    sph = [v + f + g + "launches" for v in ("", "var_")
           for f in ("", "fused_") for g in ("", "gated_")]
    return ([(density_sums, a) for a in sph if "fused_" not in a]
            + [(force_sums, a) for a in sph]
            + [(grav_short_sums, "launches"),
               (grav_short_sums, "gated_launches")])


def _candidate_chunks(grid: SortedGrid, wg: int, active=None):
    """Yield (rows, idx, valid, off) for chunks of window groups: `rows`
    [Gc, wg] the groups' row indices, and, each [Gc, C], every group's 9
    candidate ranges laid end to end, padded to the longest total C over
    all groups, with a validity mask and each candidate's plane offset.
    With `active` = (worklist, count) only the groups worklist[:count]
    (the count is read here: the plain versions may wait for the
    device)."""
    dev = grid.key.device
    ext = (grid.ends - grid.starts).long()                      # [G, 9]
    cum = torch.cumsum(ext, dim=1)
    C = max(int(cum[:, -1].max()), 1)
    step = max(1, PAIR_BUDGET // (wg * C))
    lane = torch.arange(C, device=dev)
    offs = torch.tensor(PLANE_OFFSETS, dtype=torch.int32, device=dev)
    if active is None:
        listed = torch.arange(grid.starts.shape[0], device=dev)
    else:
        listed = active[0][:int(active[1][0])].long()
    in_group = torch.arange(wg, device=dev)
    for g0 in range(0, listed.shape[0], step):
        sel = listed[g0:g0 + step]
        c = cum[sel]
        # the range each lane falls in (9 = past the group's last range)
        o = torch.searchsorted(c, lane.expand(sel.shape[0], C).contiguous(),
                               right=True)
        valid = o < 9
        o = torch.clamp(o, max=8)
        first = torch.gather(c - ext[sel], 1, o)  # lane where range o starts
        idx = torch.gather(grid.starts[sel].long(), 1, o) + lane - first
        yield (sel[:, None] * wg + in_group, torch.where(valid, idx, 0),
               valid, offs[o])


def _pair_geometry(pos: torch.Tensor, grid: SortedGrid, rows, idx, valid,
                   off):
    """(key mask [Gc, wg, C], dx, dy, dz, r2) of one chunk of the sorted
    positions `pos` [N, 3]."""
    ki = grid.key[rows][:, :, None]
    kj = grid.key[idx][:, None, :]
    offc = off[:, None, :]
    mask = (valid[:, None, :] & (kj >= ki + offc - 1)
            & (kj <= ki + offc + 1))
    d = [pos[rows, c][:, :, None] - pos[idx, c][:, None, :]
         for c in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return mask, d[0], d[1], d[2], r2


def density_sums_plain(p: Particles, cfg: SimConfig, grid: SortedGrid,
                       active=None):
    """Plain PyTorch version of `density_fixed_h` and `density_var_h` and,
    with `active`, of their gated forms, on any device and dtype: the same
    pair algebra (rsqrt(max(r^2, 1e-12)) form, r^2 > 0 self exclusion,
    dW/dh shape -(3 w + q w')) over the same ranges, in chunks of window
    groups."""
    wg = cfg.window_group
    _groups(p.capacity, cfg, grid)
    var = cfg.fixed_h is None
    m_all = torch.where(p.alive, p.mass, 0.0)
    rho = torch.zeros_like(p.h)
    omega = torch.zeros_like(p.h)
    for rows, idx, valid, off in _candidate_chunks(grid, wg, active):
        mask, _, _, _, r2 = _pair_geometry(p.pos, grid, rows, idx, valid,
                                           off)
        inv_hi = 1.0 / p.h[rows][:, :, None]
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1.0e-12))
        q = r * inv_hi
        w = w_shape(q)
        m = torch.where(mask & (r2 > 0.0), m_all[idx][:, None, :], 0.0)
        inv_pi_h3 = (1.0 / PI) * inv_hi * inv_hi * inv_hi
        rho[rows] = (torch.sum(m * w, dim=-1, keepdim=True)
                     * inv_pi_h3)[:, :, 0]
        if var:
            dwdh = -(3.0 * w + q * dw_shape(q))
            omega[rows] = (torch.sum(m * dwdh, dim=-1, keepdim=True)
                           * inv_pi_h3 * inv_hi)[:, :, 0]
    return rho, omega


def density(p: Particles, cfg: SimConfig, grid: SortedGrid, active=None,
            act_mask=None) -> Particles:
    """`p` with rho and omega from the density pass: the sums, the self
    term and the grad-h correction (`pairs.finalize_density`); omega is 1
    with fixed h.  Counterpart of `pallas_density`, which the h-iteration
    re-sums through.  With `active` = (worklist, count) and `act_mask` [N]
    bool (block timesteps) only the listed groups are summed, and rows
    outside `act_mask` keep their incoming rho and omega."""
    rho_raw, omega_raw = density_sums(p, cfg, grid, active)
    rho, omega = pairs.finalize_density(rho_raw, omega_raw, p.h, p.alive,
                                        p.mass)
    if cfg.fixed_h is not None:
        omega = torch.ones_like(omega)
    if act_mask is not None:
        rho = torch.where(act_mask, rho, p.rho)
        omega = torch.where(act_mask, omega, p.omega)
    return p.replace(rho=rho, omega=omega)


# ----------------------------------------------------------------- force

def force_sums(p: Particles, cfg: SimConfig, grid: SortedGrid,
               grav_split=None, active=None):
    """(ax, ay, az, du, alpha_raw), each [N]: pressure + Monaghan
    viscosity, with one dW for fixed h or the grad-h pair of gradients and
    hbar for variable h.  `p` must carry rho/P/omega/cs from the density
    pass.  With `grav_split` = (r_s, r_cut) also the short-range gravity
    sums over the same windows, as a last element (gx, gy, gz) (the fused
    form, `pallas_force_sums` with fuse_grav; the caller checks that r_cut
    fits the SPH cell).  With `active` = (worklist, count) only the listed
    window groups, 0 on the rest.  CPU: the plain version; CUDA:
    `force_fixed_h` or `force_var_h`, or with `grav_split`
    `force_fixed_h_grav` or `force_var_h_grav`, by cfg.fixed_h, or with
    `active` the `_gated` form of the same."""
    if _on_cpu(p.pos):
        return force_sums_plain(p, cfg, grid, grav_split, active)
    n = p.capacity
    groups = _groups(n, cfg, grid)
    h = p.h.contiguous()
    pres, omega = p.pressure.contiguous(), p.omega.contiguous()
    _check_cuda_inputs(
        n, groups, {"x": p.pos[:, 0], "vx": p.vel[:, 0], "m": p.mass,
                    "h": h, "pressure": pres, "rho": p.rho, "omega": omega,
                    "cs": p.cs, "alpha": p.alpha}, {"key": grid.key}, grid,
        packed=("x", "vx", "m", "rho", "cs", "alpha"))
    var = cfg.fixed_h is None
    geo, attr, sup2 = pack_force(p, grid.key, var)
    gated, fused = active is not None, grav_split is not None
    gate = _gate_pointers(active, groups, p.pos.device) if gated else ()
    # a gated kernel leaves unlisted rows unwritten: they must read 0
    outs = (torch.zeros if gated else torch.empty)(
        (8 if fused else 5, n), dtype=torch.float32, device=p.pos.device)
    stream = torch.cuda.current_stream(p.pos.device).cuda_stream
    args = (geo.data_ptr(), attr.data_ptr(),
            sup2.data_ptr() if var else None, h.data_ptr(),
            pres.data_ptr(), omega.data_ptr(), grid.starts.data_ptr(),
            grid.ends.data_ptr(), *(outs[c].data_ptr() for c in range(5)))
    grav = ()
    if fused:
        split = _split_buffer(grav_split, p.pos.device)
        grav = (split.data_ptr(), *(outs[c].data_ptr() for c in range(5, 8)))
    name = (("force_var_h" if var else "force_fixed_h")
            + ("_grav" if fused else "") + ("_gated" if gated else ""))
    _launch(getattr(_library(), name), *args, *grav, *gate, n,
            cfg.window_group, cfg.av_eps, cfg.beta_factor, stream)
    _count(force_sums, var, fused, gated)
    if not fused:
        return tuple(outs)
    return tuple(outs[:5]) + (tuple(outs[5:]),)


def force_sums_plain(p: Particles, cfg: SimConfig, grid: SortedGrid,
                     grav_split=None, active=None):
    """Plain PyTorch version of `force_fixed_h` and `force_var_h` (with
    `grav_split` of their fused forms, with `active` of the gated form of
    any of the four), on any device and dtype: the
    Pallas algebra (one dW with fixed h; dW_i, dW_j, their mean and hbar
    with variable h; the 1e-30 guards on pterm_j and rhobar, the rsqrt
    clamp, no explicit r > 0 guard) over the same ranges, in chunks."""
    wg = cfg.window_group
    _groups(p.capacity, cfg, grid)
    var = cfg.fixed_h is None
    m_all = torch.where(p.alive, p.mass, 0.0)
    pterm_all = p.pressure / torch.clamp(p.omega * p.rho * p.rho,
                                         min=1.0e-30)
    if var:
        inv_hj_all = 1.0 / p.h
        inv_pi_hj4_all = (((1.0 / PI) * inv_hj_all * inv_hj_all)
                          * (inv_hj_all * inv_hj_all))
    nc = 5 if grav_split is None else 8
    outs = torch.zeros((nc, p.capacity), dtype=p.pos.dtype,
                       device=p.pos.device)
    for rows, idx, valid, off in _candidate_chunks(grid, wg, active):
        mask, dxx, dxy, dxz, r2 = _pair_geometry(p.pos, grid, rows, idx,
                                                 valid, off)

        def ri(a):
            return a[rows][:, :, None]

        def cj(a):
            return a[idx][:, None, :]

        hi, rhoi = ri(p.h), ri(p.rho)
        pterm_i = ri(p.pressure) / (ri(p.omega) * rhoi * rhoi)
        inv_hi = 1.0 / hi
        inv_pi_hi4 = (1.0 / PI) * inv_hi * inv_hi * inv_hi * inv_hi
        inv_r = torch.rsqrt(torch.clamp(r2, min=1.0e-12))
        r = r2 * inv_r
        dw = dw_shape(r * inv_hi) * inv_pi_hi4
        if var:
            dw_j = dw_shape(r * cj(inv_hj_all)) * cj(inv_pi_hj4_all)
            dwbar = 0.5 * (dw + dw_j)
            hbar = 0.5 * (hi + cj(p.h))
        else:
            dwbar, hbar = dw, hi
        vx = ri(p.vel[:, 0]) - cj(p.vel[:, 0])
        vy = ri(p.vel[:, 1]) - cj(p.vel[:, 1])
        vz = ri(p.vel[:, 2]) - cj(p.vel[:, 2])
        vdotr = vx * dxx + vy * dxy + vz * dxz
        mu = (hbar * torch.clamp(vdotr, max=0.0)
              / (r2 + cfg.av_eps * hbar * hbar))
        cbar = 0.5 * (ri(p.cs) + cj(p.cs))
        abar = 0.5 * (ri(p.alpha) + cj(p.alpha))
        rhobar = 0.5 * (rhoi + cj(p.rho))
        visc = ((-abar * cbar * mu + cfg.beta_factor * abar * mu * mu)
                / torch.clamp(rhobar, min=1.0e-30))
        m = torch.where(mask, m_all[idx][:, None, :], 0.0)
        if var:
            scal = pterm_i * dw + cj(pterm_all) * dw_j + visc * dwbar
        else:  # dw_i == dw_j == dwbar
            scal = (pterm_i + cj(pterm_all) + visc) * dw
        coef = -m * scal * inv_r
        vdotgradw = vdotr * inv_r * dwbar
        sums = [coef * dxx, coef * dxy, coef * dxz,
                m * vdotgradw * (pterm_i + 0.5 * visc), m * vdotgradw]
        if grav_split is not None:
            gcoef = _grav_coef(r2, hi, m, mask, grav_split)
            sums += [gcoef * dxx, gcoef * dxy, gcoef * dxz]
        for c, s in enumerate(sums):
            outs[c, rows] = torch.sum(s, dim=-1)
    if grav_split is None:
        return tuple(outs)
    return tuple(outs[:5]) + (tuple(outs[5:]),)


# ----------------------------------------------------- short-range gravity

def _grav_coef(r2, h_i, m, mask, grav_split):
    """-G m_j [f(r / h_i) - S(r)] / r^3 on the pairs with mask, 0 < r and
    r < r_cut, else 0: the Pallas kernels' short-range gravity algebra
    (rsqrt(max(r^2, 1e-12)), `erf_approx`, receiver-side softening)."""
    from .pm_gravity import _short_factor

    r_s, r_cut = grav_split
    inv_r = torch.rsqrt(torch.clamp(r2, min=1.0e-12))
    gshort = _short_factor(r2 * inv_r, h_i, r_s)
    mg = torch.where(mask & (r2 > 0.0) & (r2 < r_cut * r_cut), m, 0.0)
    return (-G) * mg * gshort * (inv_r * inv_r * inv_r)


def grav_short_sums(pos: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
                    grid: SortedGrid, cfg: SimConfig, grav_split,
                    active=None):
    """(gx, gy, gz), each [N]: the TreePM short-range gravity sums
    sum_j -G m_j [f(r_ij / h_i) - S(r_ij)] r_ij / r_ij^3 over 0 < r < r_cut
    on the gravity sort -- `pos` [N, 3], the masked mass `m` and `h` in
    the sorted order of `grid`, whose cells are r_cut wide
    (`pm_gravity.pm_short_range`).  Counterpart of
    `pallas_grav_short_sums`.  With `active` = (worklist, count), over the
    groups of this sort, only the listed ones, 0 on the rest.  CPU: the
    plain version; CUDA: the `grav_short` kernel, with `active`
    `grav_short_gated`."""
    if _on_cpu(pos):
        return grav_short_sums_plain(pos, m, h, grid, cfg, grav_split,
                                     active)
    n = pos.shape[0]
    groups = _groups(n, cfg, grid)
    m, h = m.contiguous(), h.contiguous()
    _check_cuda_inputs(n, groups, {"x": pos[:, 0], "m": m, "h": h},
                       {"key": grid.key}, grid, packed=("x",))
    geo = pack_geometry(pos, grid.key)
    split = _split_buffer(grav_split, pos.device)
    gated = active is not None
    gate = _gate_pointers(active, groups, pos.device) if gated else ()
    # a gated kernel leaves unlisted rows unwritten: they must read 0
    outs = (torch.zeros if gated else torch.empty)(
        (3, n), dtype=torch.float32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    lib = _library()
    _launch(lib.grav_short_gated if gated else lib.grav_short,
            geo.data_ptr(), m.data_ptr(), h.data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(), split.data_ptr(),
            *(outs[c].data_ptr() for c in range(3)), *gate,
            n, cfg.window_group, stream)
    _count(grav_short_sums, False, False, gated)
    return tuple(outs)


def grav_short_sums_plain(pos: torch.Tensor, m: torch.Tensor,
                          h: torch.Tensor, grid: SortedGrid, cfg: SimConfig,
                          grav_split, active=None):
    """Plain PyTorch version of `grav_short` and, with `active`, of
    `grav_short_gated`, on any device and dtype: the same sums over the
    same ranges, in chunks of window groups."""
    wg = cfg.window_group
    _groups(pos.shape[0], cfg, grid)
    outs = torch.zeros((3, pos.shape[0]), dtype=pos.dtype,
                       device=pos.device)
    for rows, idx, valid, off in _candidate_chunks(grid, wg, active):
        mask, dxx, dxy, dxz, r2 = _pair_geometry(pos, grid, rows, idx,
                                                 valid, off)
        gcoef = _grav_coef(r2, h[rows][:, :, None], m[idx][:, None, :],
                           mask, grav_split)
        for c, d in enumerate((dxx, dxy, dxz)):
            outs[c, rows] = torch.sum(gcoef * d, dim=-1)
    return tuple(outs)


# ------------------------------------------------------------ pair passes

def pair_eval(p: Particles, cfg: SimConfig, grid: SortedGrid,
              grav_split=None, active=None, act_mask=None):
    """Density -> EOS -> forces on the sorted particles.  Counterpart of
    `pallas_pair_eval`.  Returns (p with rho/omega/pressure/cs, acc [N, 3],
    du, dalpha[, acc_grav [N, 3]]), the rates zero on dead rows; the last
    only with `grav_split` = (r_s, r_cut): the fused short-range gravity
    acceleration (cfg.grav_fuse_short).

    Block timesteps pass `active` = (worklist, count) and `act_mask` [N]
    bool: only the listed window groups are summed; rows outside
    `act_mask` keep the rho and omega they came with (the substep sort
    carried them), the EOS runs on the merged arrays, so the force pass
    reads the stale values of inactive neighbours, and the returned rates
    are exactly 0 outside alive & act_mask."""
    p = eos_update(density(p, cfg, grid, active, act_mask), cfg)
    out = force_sums(p, cfg, grid, grav_split, active)
    ax, ay, az, du, araw = out[:5]
    acc = torch.stack([ax, ay, az], dim=-1)
    dalpha = pairs.alpha_rate(araw, p.rho, p.alpha, p.cs, p.h, cfg)
    alive = p.alive if act_mask is None else p.alive & act_mask
    res = (p, torch.where(alive[:, None], acc, 0.0),
           torch.where(alive, du, 0.0), torch.where(alive, dalpha, 0.0))
    if grav_split is not None:
        res += (torch.where(alive[:, None], torch.stack(out[5], dim=-1),
                            0.0),)
    return res


def window_overflow(grid: SortedGrid, cfg: SimConfig) -> torch.Tensor:
    """Candidates beyond the pair passes' coverage (stats slot 0).  Both
    the kernels and the plain versions cover every group's whole
    [starts, ends), so nothing is beyond it: always 0."""
    return torch.zeros((), dtype=torch.int32, device=grid.key.device)


for _wrapper, _attr in launch_counters():
    setattr(_wrapper, _attr, 0)
pack_force.launches = 0

__all__ = ["density_sums", "density_sums_plain", "density", "force_sums",
           "force_sums_plain", "pack_force", "pack_force_plain",
           "pack_geometry", "grav_short_sums", "grav_short_sums_plain",
           "pair_eval", "window_overflow", "launch_counters", "SOURCE"]
