"""SPH pair passes on the sorted windows: CUDA kernels and their plain
PyTorch versions.  Counterpart of `summersph_tpu/ops/pallas_pairs.py`.

`density_sums` and `force_sums` dispatch by device: a tensor on the CPU
takes the plain version (`density_sums_plain`, `force_sums_plain`), a
tensor on a CUDA card launches the hand-written kernel
(`csrc/sph_pairs.cu`: `density_fixed_h`, `force_fixed_h`) or raises.
There is no fallback from the kernel to the plain version.  Each wrapper
counts its kernel launches in a plain integer attribute `launches`.

Both versions compute the same sums over the same ranges: for every
window group of `cfg.window_group` sorted rows and each of the 9 plane
offsets, every candidate in the group's true [starts, ends), under each
row's exact key mask.  The TPU kernels' DMA layout (the [F, N] pack with
the bitcast key, 128-lane aligned fetches, 3-bit packed plans, exact-window
rotations, double buffering) has no counterpart: it exists for Mosaic, and
walking the true ranges computes what it computes.  Because nothing is
capped, `window_overflow` is 0.

Fixed h only (the main path); the kernels take float32 only, as the TPU
kernels do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import SimConfig
from ..state import Particles
from ..utils import build
from ..utils.units import PI
from . import pairs
from .eos import eos_update
from .kernels import dw_shape, w_shape
from .sorted_grid import PLANE_OFFSETS, SortedGrid

SOURCE = "summersph_tpu_torch/csrc/sph_pairs.cu"

# Pair elements per chunk of window groups in the plain versions, which
# bounds their memory (about 30 temporaries of this many elements).
PAIR_BUDGET = 1 << 23


def _require_fixed_h(cfg: SimConfig):
    if cfg.fixed_h is None:
        raise NotImplementedError(
            "the pair passes are ported for fixed h only (cfg.fixed_h); "
            "variable h is later work")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("sph_pairs")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.density_fixed_h.argtypes = [ptr] * 9 + [i32, i32, ptr]
    lib.density_fixed_h.restype = i32
    lib.force_fixed_h.argtypes = [ptr] * 21 + [i32, i32, f32, f32, ptr]
    lib.force_fixed_h.restype = i32
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


def _groups(p: Particles, cfg: SimConfig, grid: SortedGrid) -> int:
    n, wg = p.capacity, cfg.window_group
    if n % wg or grid.starts.shape[0] != n // wg:
        raise ValueError(f"{n} rows do not tile into window groups of {wg} "
                         f"matching grid.starts {tuple(grid.starts.shape)}")
    return n // wg


# --------------------------------------------------------------- density

def density_sums(p: Particles, cfg: SimConfig,
                 grid: SortedGrid) -> torch.Tensor:
    """rho_raw [N] = sum_j m_j W(r_ij, h_i) over the windows, self excluded
    (pairs.finalize_density adds it).  CPU: the plain version; CUDA: the
    `density_fixed_h` kernel."""
    _require_fixed_h(cfg)
    if p.pos.device.type == "cpu":
        return density_sums_plain(p, cfg, grid)
    n = p.capacity
    groups = _groups(p, cfg, grid)
    pos, m = _soa(p)
    h = p.h.contiguous()
    _check_cuda_inputs(n, groups,
                       {"x": pos[0], "y": pos[1], "z": pos[2], "m": m,
                        "h": h}, {"key": grid.key}, grid)
    rho = torch.empty(n, dtype=torch.float32, device=p.pos.device)
    stream = torch.cuda.current_stream(p.pos.device).cuda_stream
    _launch(_library().density_fixed_h,
            pos[0].data_ptr(), pos[1].data_ptr(), pos[2].data_ptr(),
            m.data_ptr(), h.data_ptr(), grid.key.data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(), rho.data_ptr(),
            n, cfg.window_group, stream)
    density_sums.launches += 1
    return rho


density_sums.launches = 0


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


def _pair_geometry(p: Particles, grid: SortedGrid, wg: int, g0, g1, idx,
                   valid, off):
    """(rows slice, key mask [Gc, wg, C], dx, dy, dz, r2) of one chunk."""
    gc = g1 - g0
    rows = slice(g0 * wg, g1 * wg)
    ki = grid.key[rows].reshape(gc, wg, 1)
    kj = grid.key[idx][:, None, :]
    offc = off[:, None, :]
    mask = (valid[:, None, :] & (kj >= ki + offc - 1)
            & (kj <= ki + offc + 1))
    d = [p.pos[rows, c].reshape(gc, wg, 1) - p.pos[idx, c][:, None, :]
         for c in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return rows, mask, d[0], d[1], d[2], r2


def density_sums_plain(p: Particles, cfg: SimConfig,
                       grid: SortedGrid) -> torch.Tensor:
    """Plain PyTorch version of `density_fixed_h`, on any device and dtype:
    the same pair algebra (rsqrt(max(r^2, 1e-12)) form, r^2 > 0 self
    exclusion) over the same ranges, in chunks of window groups."""
    _require_fixed_h(cfg)
    wg = cfg.window_group
    _groups(p, cfg, grid)
    m_all = torch.where(p.alive, p.mass, 0.0)
    out = torch.empty_like(p.h)
    for g0, g1, idx, valid, off in _candidate_chunks(grid, wg):
        rows, mask, _, _, _, r2 = _pair_geometry(p, grid, wg, g0, g1, idx,
                                                 valid, off)
        inv_hi = 1.0 / p.h[rows].reshape(g1 - g0, wg, 1)
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1.0e-12))
        w = w_shape(r * inv_hi)
        m = torch.where(mask & (r2 > 0.0), m_all[idx][:, None, :], 0.0)
        inv_pi_h3 = (1.0 / PI) * inv_hi * inv_hi * inv_hi
        out[rows] = (torch.sum(m * w, dim=-1, keepdim=True)
                     * inv_pi_h3).reshape(-1)
    return out


# ----------------------------------------------------------------- force

def force_sums(p: Particles, cfg: SimConfig, grid: SortedGrid):
    """(ax, ay, az, du, alpha_raw), each [N]: pressure + Monaghan
    viscosity with one dW (fixed h).  `p` must carry rho/P/omega/cs from
    the density pass.  CPU: the plain version; CUDA: the `force_fixed_h`
    kernel."""
    _require_fixed_h(cfg)
    if p.pos.device.type == "cpu":
        return force_sums_plain(p, cfg, grid)
    n = p.capacity
    groups = _groups(p, cfg, grid)
    pos, m = _soa(p)
    vel = p.vel.t().contiguous()
    fields = {"x": pos[0], "y": pos[1], "z": pos[2], "vx": vel[0],
              "vy": vel[1], "vz": vel[2], "m": m, "h": p.h.contiguous(),
              "pressure": p.pressure.contiguous(), "rho": p.rho.contiguous(),
              "omega": p.omega.contiguous(), "cs": p.cs.contiguous(),
              "alpha": p.alpha.contiguous()}
    _check_cuda_inputs(n, groups, fields, {"key": grid.key}, grid)
    outs = torch.empty((5, n), dtype=torch.float32, device=p.pos.device)
    f = fields
    stream = torch.cuda.current_stream(p.pos.device).cuda_stream
    _launch(_library().force_fixed_h,
            f["x"].data_ptr(), f["y"].data_ptr(), f["z"].data_ptr(),
            f["vx"].data_ptr(), f["vy"].data_ptr(), f["vz"].data_ptr(),
            f["m"].data_ptr(), f["h"].data_ptr(), grid.key.data_ptr(),
            f["pressure"].data_ptr(), f["rho"].data_ptr(),
            f["omega"].data_ptr(), f["cs"].data_ptr(), f["alpha"].data_ptr(),
            grid.starts.data_ptr(), grid.ends.data_ptr(),
            *(outs[c].data_ptr() for c in range(5)),
            n, cfg.window_group, cfg.av_eps, cfg.beta_factor, stream)
    force_sums.launches += 1
    return tuple(outs)


force_sums.launches = 0


def force_sums_plain(p: Particles, cfg: SimConfig, grid: SortedGrid):
    """Plain PyTorch version of `force_fixed_h`, on any device and dtype:
    the Pallas fixed-h algebra (one dW, the 1e-30 guards, the rsqrt clamp,
    no explicit r > 0 guard) over the same ranges, in chunks."""
    _require_fixed_h(cfg)
    wg = cfg.window_group
    _groups(p, cfg, grid)
    m_all = torch.where(p.alive, p.mass, 0.0)
    pterm_all = p.pressure / torch.clamp(p.omega * p.rho * p.rho,
                                         min=1.0e-30)
    outs = torch.empty((5, p.capacity), dtype=p.pos.dtype,
                       device=p.pos.device)
    for g0, g1, idx, valid, off in _candidate_chunks(grid, wg):
        gc = g1 - g0
        rows, mask, dxx, dxy, dxz, r2 = _pair_geometry(p, grid, wg, g0, g1,
                                                       idx, valid, off)

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
        vx = ri(p.vel[:, 0]) - cj(p.vel[:, 0])
        vy = ri(p.vel[:, 1]) - cj(p.vel[:, 1])
        vz = ri(p.vel[:, 2]) - cj(p.vel[:, 2])
        vdotr = vx * dxx + vy * dxy + vz * dxz
        mu = hi * torch.clamp(vdotr, max=0.0) / (r2 + cfg.av_eps * hi * hi)
        cbar = 0.5 * (ri(p.cs) + cj(p.cs))
        abar = 0.5 * (ri(p.alpha) + cj(p.alpha))
        rhobar = 0.5 * (rhoi + cj(p.rho))
        visc = ((-abar * cbar * mu + cfg.beta_factor * abar * mu * mu)
                / torch.clamp(rhobar, min=1.0e-30))
        m = torch.where(mask, m_all[idx][:, None, :], 0.0)
        coef = -m * ((pterm_i + cj(pterm_all) + visc) * dw) * inv_r
        vdotgradw = vdotr * inv_r * dw
        sums = (coef * dxx, coef * dxy, coef * dxz,
                m * vdotgradw * (pterm_i + 0.5 * visc), m * vdotgradw)
        for c, s in enumerate(sums):
            outs[c, rows] = torch.sum(s, dim=-1).reshape(-1)
    return tuple(outs)


# ------------------------------------------------------------ pair passes

def pair_eval(p: Particles, cfg: SimConfig, grid: SortedGrid):
    """Density -> EOS -> forces on the sorted particles.  Counterpart of
    `pallas_pair_eval`.  Returns (p with rho/omega/pressure/cs, acc [N, 3],
    du, dalpha), the rates zero on dead rows."""
    rho_raw = density_sums(p, cfg, grid)
    rho, _ = pairs.finalize_density(rho_raw, torch.zeros_like(rho_raw), p.h,
                                    p.alive, p.mass)
    p = eos_update(p.replace(rho=rho, omega=torch.ones_like(rho)), cfg)
    ax, ay, az, du, araw = force_sums(p, cfg, grid)
    acc = torch.stack([ax, ay, az], dim=-1)
    dalpha = pairs.alpha_rate(araw, rho, p.alpha, p.cs, p.h, cfg)
    alive = p.alive
    return (p, torch.where(alive[:, None], acc, 0.0),
            torch.where(alive, du, 0.0), torch.where(alive, dalpha, 0.0))


def window_overflow(grid: SortedGrid, cfg: SimConfig) -> torch.Tensor:
    """Candidates beyond the pair passes' coverage (stats slot 0).  Both
    the kernels and the plain versions cover every group's whole
    [starts, ends), so nothing is beyond it: always 0."""
    return torch.zeros((), dtype=torch.int32, device=grid.key.device)


__all__ = ["density_sums", "density_sums_plain", "force_sums",
           "force_sums_plain", "pair_eval", "window_overflow", "SOURCE"]
