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

Both versions compute the same sums over the same ranges: for every
window group of `cfg.window_group` sorted rows and each of the 9 plane
offsets, every candidate in the group's true [starts, ends), under each
row's exact key mask.  The TPU kernels' DMA layout (the [F, N] pack with
the bitcast key, 128-lane aligned fetches, 3-bit packed plans, exact-window
rotations, double buffering) has no counterpart: it exists for Mosaic, and
walking the true ranges computes what it computes.  Because nothing is
capped, `window_overflow` is 0.

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
            ("density_fixed_h", 9, [i32, i32, ptr]),
            ("density_var_h", 10, [i32, i32, ptr]),
            ("force_fixed_h", 21, [i32, i32, f32, f32, ptr]),
            ("force_var_h", 21, [i32, i32, f32, f32, ptr]),
            ("force_fixed_h_grav", 25, [i32, i32, f32, f32, ptr]),
            ("force_var_h_grav", 25, [i32, i32, f32, f32, ptr]),
            ("grav_short", 12, [i32, i32, ptr])):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptr + tail
        fn.restype = i32
    return lib


def _check_cuda_inputs(n: int, groups: int, floats, ints, grid: SortedGrid):
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"CUDA pair kernels take float32 only; {name} "
                            f"is {t.dtype}")
    for name, t in {**floats, **ints}.items():
        if not t.is_cuda or not t.is_contiguous() or t.shape != (n,):
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


def _launch(fn, *args):
    """Call a C entry point and raise on its cudaGetLastError().  Kernels
    run on PyTorch's current stream, so the temporaries the wrappers pass
    may be freed on return: the caching allocator reuses their memory only
    for work ordered after the kernel on that stream."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _soa(p: Particles):
    """[3, N] positions and the masked mass of the sorted rows (dead
    particles carry mass 0, as in the TPU pack)."""
    return (p.pos.t().contiguous(),
            torch.where(p.alive, p.mass, 0.0).contiguous())


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

def density_sums(p: Particles, cfg: SimConfig, grid: SortedGrid):
    """(rho_raw, omega_raw), each [N]: rho_raw = sum_j m_j W(r_ij, h_i)
    over the windows, self excluded (pairs.finalize_density adds it), and
    with variable h the grad-h sum omega_raw = sum_j m_j dW/dh(r_ij, h_i);
    with fixed h omega_raw is zero, as `pallas_density_sums` returns it.
    CPU: the plain version; CUDA: the `density_fixed_h` kernel, or
    `density_var_h` when cfg.fixed_h is None."""
    if _on_cpu(p.pos):
        return density_sums_plain(p, cfg, grid)
    n = p.capacity
    groups = _groups(n, cfg, grid)
    pos, m = _soa(p)
    h = p.h.contiguous()
    _check_cuda_inputs(n, groups,
                       {"x": pos[0], "y": pos[1], "z": pos[2], "m": m,
                        "h": h}, {"key": grid.key}, grid)
    rho = torch.empty(n, dtype=torch.float32, device=p.pos.device)
    stream = torch.cuda.current_stream(p.pos.device).cuda_stream
    args = (pos[0].data_ptr(), pos[1].data_ptr(), pos[2].data_ptr(),
            m.data_ptr(), h.data_ptr(), grid.key.data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(), rho.data_ptr())
    if cfg.fixed_h is not None:
        _launch(_library().density_fixed_h, *args, n, cfg.window_group,
                stream)
        density_sums.launches += 1
        return rho, torch.zeros_like(rho)
    omega = torch.empty_like(rho)
    _launch(_library().density_var_h, *args, omega.data_ptr(), n,
            cfg.window_group, stream)
    density_sums.var_launches += 1
    return rho, omega


density_sums.launches = 0
density_sums.var_launches = 0


def _candidate_chunks(grid: SortedGrid, wg: int):
    """Yield (g0, g1, idx, valid, off), each [Gc, C], for window groups
    g0..g1-1: every group's 9 candidate ranges laid end to end, padded to
    the longest total C over all groups, with a validity mask and each
    candidate's plane offset."""
    dev = grid.key.device
    ext = (grid.ends - grid.starts).long()                      # [G, 9]
    cum = torch.cumsum(ext, dim=1)
    C = max(int(cum[:, -1].max()), 1)
    step = max(1, PAIR_BUDGET // (wg * C))
    lane = torch.arange(C, device=dev)
    offs = torch.tensor(PLANE_OFFSETS, dtype=torch.int32, device=dev)
    for g0 in range(0, grid.starts.shape[0], step):
        g1 = min(grid.starts.shape[0], g0 + step)
        c = cum[g0:g1]
        # the range each lane falls in (9 = past the group's last range)
        o = torch.searchsorted(c, lane.expand(g1 - g0, C).contiguous(),
                               right=True)
        valid = o < 9
        o = torch.clamp(o, max=8)
        first = torch.gather(c - ext[g0:g1], 1, o)  # lane where range o starts
        idx = torch.gather(grid.starts[g0:g1].long(), 1, o) + lane - first
        yield g0, g1, torch.where(valid, idx, 0), valid, offs[o]


def _pair_geometry(pos: torch.Tensor, grid: SortedGrid, wg: int, g0, g1,
                   idx, valid, off):
    """(rows slice, key mask [Gc, wg, C], dx, dy, dz, r2) of one chunk of
    the sorted positions `pos` [N, 3]."""
    gc = g1 - g0
    rows = slice(g0 * wg, g1 * wg)
    ki = grid.key[rows].reshape(gc, wg, 1)
    kj = grid.key[idx][:, None, :]
    offc = off[:, None, :]
    mask = (valid[:, None, :] & (kj >= ki + offc - 1)
            & (kj <= ki + offc + 1))
    d = [pos[rows, c].reshape(gc, wg, 1) - pos[idx, c][:, None, :]
         for c in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return rows, mask, d[0], d[1], d[2], r2


def density_sums_plain(p: Particles, cfg: SimConfig, grid: SortedGrid):
    """Plain PyTorch version of `density_fixed_h` and `density_var_h`, on
    any device and dtype: the same pair algebra (rsqrt(max(r^2, 1e-12))
    form, r^2 > 0 self exclusion, dW/dh shape -(3 w + q w')) over the same
    ranges, in chunks of window groups."""
    wg = cfg.window_group
    _groups(p.capacity, cfg, grid)
    var = cfg.fixed_h is None
    m_all = torch.where(p.alive, p.mass, 0.0)
    rho = torch.empty_like(p.h)
    omega = torch.zeros_like(p.h)
    for g0, g1, idx, valid, off in _candidate_chunks(grid, wg):
        rows, mask, _, _, _, r2 = _pair_geometry(p.pos, grid, wg, g0, g1,
                                                 idx, valid, off)
        inv_hi = 1.0 / p.h[rows].reshape(g1 - g0, wg, 1)
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1.0e-12))
        q = r * inv_hi
        w = w_shape(q)
        m = torch.where(mask & (r2 > 0.0), m_all[idx][:, None, :], 0.0)
        inv_pi_h3 = (1.0 / PI) * inv_hi * inv_hi * inv_hi
        rho[rows] = (torch.sum(m * w, dim=-1, keepdim=True)
                     * inv_pi_h3).reshape(-1)
        if var:
            dwdh = -(3.0 * w + q * dw_shape(q))
            omega[rows] = (torch.sum(m * dwdh, dim=-1, keepdim=True)
                           * inv_pi_h3 * inv_hi).reshape(-1)
    return rho, omega


def density(p: Particles, cfg: SimConfig, grid: SortedGrid) -> Particles:
    """`p` with rho and omega from the density pass: the sums, the self
    term and the grad-h correction (`pairs.finalize_density`); omega is 1
    with fixed h.  Counterpart of `pallas_density`, which the h-iteration
    re-sums through."""
    rho_raw, omega_raw = density_sums(p, cfg, grid)
    rho, omega = pairs.finalize_density(rho_raw, omega_raw, p.h, p.alive,
                                        p.mass)
    if cfg.fixed_h is not None:
        omega = torch.ones_like(omega)
    return p.replace(rho=rho, omega=omega)


# ----------------------------------------------------------------- force

def force_sums(p: Particles, cfg: SimConfig, grid: SortedGrid,
               grav_split=None):
    """(ax, ay, az, du, alpha_raw), each [N]: pressure + Monaghan
    viscosity, with one dW for fixed h or the grad-h pair of gradients and
    hbar for variable h.  `p` must carry rho/P/omega/cs from the density
    pass.  With `grav_split` = (r_s, r_cut) also the short-range gravity
    sums over the same windows, as a last element (gx, gy, gz) (the fused
    form, `pallas_force_sums` with fuse_grav; the caller checks that r_cut
    fits the SPH cell).  CPU: the plain version; CUDA: `force_fixed_h` or
    `force_var_h`, or with `grav_split` `force_fixed_h_grav` or
    `force_var_h_grav`, by cfg.fixed_h."""
    if _on_cpu(p.pos):
        return force_sums_plain(p, cfg, grid, grav_split)
    n = p.capacity
    groups = _groups(n, cfg, grid)
    pos, m = _soa(p)
    vel = p.vel.t().contiguous()
    fields = {"x": pos[0], "y": pos[1], "z": pos[2], "vx": vel[0],
              "vy": vel[1], "vz": vel[2], "m": m, "h": p.h.contiguous(),
              "pressure": p.pressure.contiguous(), "rho": p.rho.contiguous(),
              "omega": p.omega.contiguous(), "cs": p.cs.contiguous(),
              "alpha": p.alpha.contiguous()}
    _check_cuda_inputs(n, groups, fields, {"key": grid.key}, grid)
    nc = 5 if grav_split is None else 8
    outs = torch.empty((nc, n), dtype=torch.float32, device=p.pos.device)
    f = fields
    stream = torch.cuda.current_stream(p.pos.device).cuda_stream
    args = (f["x"].data_ptr(), f["y"].data_ptr(), f["z"].data_ptr(),
            f["vx"].data_ptr(), f["vy"].data_ptr(), f["vz"].data_ptr(),
            f["m"].data_ptr(), f["h"].data_ptr(), grid.key.data_ptr(),
            f["pressure"].data_ptr(), f["rho"].data_ptr(),
            f["omega"].data_ptr(), f["cs"].data_ptr(), f["alpha"].data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(),
            *(outs[c].data_ptr() for c in range(5)))
    tail = (n, cfg.window_group, cfg.av_eps, cfg.beta_factor, stream)
    lib = _library()
    var = cfg.fixed_h is None
    if grav_split is None:
        if var:
            _launch(lib.force_var_h, *args, *tail)
            force_sums.var_launches += 1
        else:
            _launch(lib.force_fixed_h, *args, *tail)
            force_sums.launches += 1
        return tuple(outs)
    split = _split_buffer(grav_split, p.pos.device)
    grav = (split.data_ptr(), *(outs[c].data_ptr() for c in range(5, 8)))
    if var:
        _launch(lib.force_var_h_grav, *args, *grav, *tail)
        force_sums.var_fused_launches += 1
    else:
        _launch(lib.force_fixed_h_grav, *args, *grav, *tail)
        force_sums.fused_launches += 1
    return tuple(outs[:5]) + (tuple(outs[5:]),)


force_sums.launches = 0
force_sums.fused_launches = 0
force_sums.var_launches = 0
force_sums.var_fused_launches = 0


def force_sums_plain(p: Particles, cfg: SimConfig, grid: SortedGrid,
                     grav_split=None):
    """Plain PyTorch version of `force_fixed_h` and `force_var_h` (and,
    with `grav_split`, of their fused forms), on any device and dtype: the
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
    outs = torch.empty((nc, p.capacity), dtype=p.pos.dtype,
                       device=p.pos.device)
    for g0, g1, idx, valid, off in _candidate_chunks(grid, wg):
        gc = g1 - g0
        rows, mask, dxx, dxy, dxz, r2 = _pair_geometry(p.pos, grid, wg, g0,
                                                       g1, idx, valid, off)

        def ri(a):
            return a[rows].reshape(gc, wg, 1)

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
            outs[c, rows] = torch.sum(s, dim=-1).reshape(-1)
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
                    grid: SortedGrid, cfg: SimConfig, grav_split):
    """(gx, gy, gz), each [N]: the TreePM short-range gravity sums
    sum_j -G m_j [f(r_ij / h_i) - S(r_ij)] r_ij / r_ij^3 over 0 < r < r_cut
    on the gravity sort -- `pos` [N, 3], the masked mass `m` and `h` in
    the sorted order of `grid`, whose cells are r_cut wide
    (`pm_gravity.pm_short_range`).  Counterpart of
    `pallas_grav_short_sums`.  CPU: the plain version; CUDA: the
    `grav_short` kernel."""
    if _on_cpu(pos):
        return grav_short_sums_plain(pos, m, h, grid, cfg, grav_split)
    n = pos.shape[0]
    groups = _groups(n, cfg, grid)
    xyz = pos.t().contiguous()
    m, h = m.contiguous(), h.contiguous()
    _check_cuda_inputs(n, groups, {"x": xyz[0], "y": xyz[1], "z": xyz[2],
                                   "m": m, "h": h}, {"key": grid.key}, grid)
    split = _split_buffer(grav_split, pos.device)
    outs = torch.empty((3, n), dtype=torch.float32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    _launch(_library().grav_short,
            xyz[0].data_ptr(), xyz[1].data_ptr(), xyz[2].data_ptr(),
            m.data_ptr(), h.data_ptr(), grid.key.data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(), split.data_ptr(),
            *(outs[c].data_ptr() for c in range(3)),
            n, cfg.window_group, stream)
    grav_short_sums.launches += 1
    return tuple(outs)


grav_short_sums.launches = 0


def grav_short_sums_plain(pos: torch.Tensor, m: torch.Tensor,
                          h: torch.Tensor, grid: SortedGrid, cfg: SimConfig,
                          grav_split):
    """Plain PyTorch version of `grav_short`, on any device and dtype: the
    same sums over the same ranges, in chunks of window groups."""
    wg = cfg.window_group
    _groups(pos.shape[0], cfg, grid)
    outs = torch.empty((3, pos.shape[0]), dtype=pos.dtype,
                       device=pos.device)
    for g0, g1, idx, valid, off in _candidate_chunks(grid, wg):
        rows, mask, dxx, dxy, dxz, r2 = _pair_geometry(pos, grid, wg, g0,
                                                       g1, idx, valid, off)
        gcoef = _grav_coef(r2, h[rows].reshape(g1 - g0, wg, 1),
                           m[idx][:, None, :], mask, grav_split)
        for c, d in enumerate((dxx, dxy, dxz)):
            outs[c, rows] = torch.sum(gcoef * d, dim=-1).reshape(-1)
    return tuple(outs)


# ------------------------------------------------------------ pair passes

def pair_eval(p: Particles, cfg: SimConfig, grid: SortedGrid,
              grav_split=None):
    """Density -> EOS -> forces on the sorted particles.  Counterpart of
    `pallas_pair_eval`.  Returns (p with rho/omega/pressure/cs, acc [N, 3],
    du, dalpha[, acc_grav [N, 3]]), the rates zero on dead rows; the last
    only with `grav_split` = (r_s, r_cut): the fused short-range gravity
    acceleration (cfg.grav_fuse_short)."""
    p = eos_update(density(p, cfg, grid), cfg)
    out = force_sums(p, cfg, grid, grav_split)
    ax, ay, az, du, araw = out[:5]
    acc = torch.stack([ax, ay, az], dim=-1)
    dalpha = pairs.alpha_rate(araw, p.rho, p.alpha, p.cs, p.h, cfg)
    alive = p.alive
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


__all__ = ["density_sums", "density_sums_plain", "density", "force_sums",
           "force_sums_plain", "grav_short_sums", "grav_short_sums_plain",
           "pair_eval", "window_overflow", "SOURCE"]
