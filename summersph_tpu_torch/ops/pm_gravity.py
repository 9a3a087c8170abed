"""TreePM self-gravity: the particle-mesh long range and the short-range
pair complement.

Counterpart of `summersph_tpu/ops/pm_gravity.py`, whose docstring gives
the method:

  F_total(r) = F_long(r) + F_short(r)

* F_long (`pm_long_range`): cloud-in-cell deposit on a `grav_grid`^3 mesh
  over the live bounding cube (`index_add_`), the isolated-boundary
  (Hockney-Eastwood) Poisson solve on the 2x zero-padded grid with
  `torch.fft.rfftn`/`irfftn` and the scale-free Green's table
  (`green_kernel_k`), the force by 4th-order finite differences
  (`grav_gradient='fd'`) or the spectral gradient, and CIC interpolation
  back to the particles.
* F_short (`pm_short_range`): the pair sum of
  g_short(r) = f_spline(r/h_i) - S(r) over 0 < r < r_cut on a slim sort
  with cells r_cut wide, through the `grav_short` CUDA kernel
  (`ops/cuda_pairs.grav_short_sums`).

The mesh is rebuilt from the particles every solve; r_s and r_cut are 0-d
tensors, so nothing in a solve waits for the card.  Single device only:
the JAX package's `rows`/`axis_name`/`decomp` branches are later work.
`grav_fft='matmul'` (the TPU's pruned matmul DFT) is accepted as another
name for the one `torch.fft` path.  The short-range kernel walks every
window group's whole candidate range, so the JAX package's overflow
worklist (`grav_overflow_items`) has nothing left to cover: the knob is
accepted, and the overflow count is 0.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..config import SimConfig
from ..state import Particles
from ..utils.units import G, PI
from .cuda_pairs import grav_short_sums
from .kernels import grav_softening
from .sorted_grid import (LANES, SENTINEL_KEY, SortedGrid, _cell_key,
                          _pad_to, group_windows)

PM_MODES = ("bh", "pm", "treepm")


@functools.lru_cache(maxsize=4)
def green_kernel_k(npad: int, grav_split_rs: float, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Scale-free isolated-boundary Green's function on the padded grid,
    in k-space: the real [npad, npad, npad // 2 + 1] rFFT of the
    open-space smoothed point-mass potential K(q) = -G erf(q / (2 r_s)) / q
    at wrapped displacements q in cell units, with the CIC window
    deconvolved twice.  K is even in every axis, so its transform is real.

    Built on `device` in float64 (erf and rfftn there), cast once to
    `dtype`, and memoized per (npad, grav_split_rs, dtype, device): the
    table never changes as the particle box rescales, so a run builds it
    once.  The cache holds up to four tables for the life of the process.
    """
    f64 = torch.float64
    idx = torch.arange(npad, dtype=f64, device=device)
    d1 = torch.where(idx <= npad // 2, idx, idx - npad)
    q = torch.sqrt(d1[:, None, None] ** 2 + d1[None, :, None] ** 2
                   + d1[None, None, :] ** 2)
    q = torch.clamp(q, min=1.0e-30)
    kq = -G * torch.special.erf(q / (2.0 * grav_split_rs)) / q
    del q
    kq[0, 0, 0] = -G / (grav_split_rs * math.sqrt(PI))
    k_table = torch.fft.rfftn(kq).real
    del kq

    def sinc2(x):
        big = torch.abs(x) > 1.0e-6
        s = torch.where(big, torch.sin(x) / torch.where(big, x, 1.0), 1.0)
        return s * s

    # k * cell / 2 on the padded grid
    kxq = sinc2(torch.fft.fftfreq(npad, dtype=f64, device=device) * PI)
    kzq = sinc2(torch.fft.rfftfreq(npad, dtype=f64, device=device) * PI)
    w_cic = kxq[:, None, None] * kxq[None, :, None] * kzq[None, None, :]
    return (k_table / torch.clamp(w_cic * w_cic, min=0.05)).to(dtype)


def grav_tables(cfg: SimConfig, dtype: torch.dtype,
                device) -> Optional[torch.Tensor]:
    """The Green's table for `cfg` on `device` (None when gravity needs
    none).  The JAX package's 'matmul' bundle of DFT matrices has no
    counterpart: both `grav_fft` settings take the one `torch.fft` path."""
    if cfg.gravity not in PM_MODES:
        return None
    return green_kernel_k(2 * cfg.grav_grid, float(cfg.grav_split_rs),
                          dtype, torch.device(device))


def _cic_corners(pos, origin, cell, n):
    """The 8 CIC corners of every particle: (flat index [N], weight [N])
    in the JAX package's corner order."""
    u = (pos - origin) / cell - 0.5
    i0 = torch.floor(u)
    frac = u - i0
    i0 = i0.to(torch.int64)
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        ix = torch.clamp(i0[:, 0] + dx, 0, n - 1)
        for dy in (0, 1):
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            iy = torch.clamp(i0[:, 1] + dy, 0, n - 1)
            for dz in (0, 1):
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                iz = torch.clamp(i0[:, 2] + dz, 0, n - 1)
                yield (ix * n + iy) * n + iz, wx * wy * wz


def _cic_deposit(pos, mass, origin, cell, n):
    """CIC (trilinear) mass deposit onto an [n, n, n] mesh, one
    `index_add_` of the 8 corners of every particle."""
    flat, w = zip(*_cic_corners(pos, origin, cell, n))
    rho = torch.zeros(n * n * n, dtype=mass.dtype, device=mass.device)
    vals = torch.cat([mass * wx for wx in w])
    rho.index_add_(0, torch.cat(flat), vals)
    return rho.reshape(n, n, n)


def _cic_gather(field, pos, origin, cell, n):
    """CIC interpolation of an [n, n, n, 3] field to particle positions."""
    flat_field = field.reshape(n * n * n, 3)
    out = torch.zeros((pos.shape[0], 3), dtype=field.dtype,
                      device=field.device)
    for flat, w in _cic_corners(pos, origin, cell, n):
        out = out + w[:, None] * flat_field[flat]
    return out


def _fd4_gradient(phi, cell):
    """4th-order central-difference force F = -grad phi, axis by axis.
    The wrap-around reads at the crop edges hit the padded half of the
    circulant potential, which holds correct open-space values."""
    comps = []
    for ax in range(3):
        d = (-torch.roll(phi, -2, ax) + 8.0 * torch.roll(phi, -1, ax)
             - 8.0 * torch.roll(phi, 1, ax) + torch.roll(phi, 2, ax)) \
            / (12.0 * cell)
        comps.append(-d)
    return comps


def pm_geometry(p: Particles, cfg: SimConfig):
    """(origin [3], cell, r_s): the mesh box over the live bounding cube
    and the Gaussian split scale, as 0-d tensors.  Deterministic in the
    particles, so a caller that needs r_s before the long-range solve (the
    fused force kernel) gets the value `pm_long_range` will use."""
    n = cfg.grav_grid
    alive3 = p.alive[:, None]
    lo = torch.amin(torch.where(alive3, p.pos, torch.inf), dim=0)
    hi = torch.amax(torch.where(alive3, p.pos, -torch.inf), dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    # all particles in mesh cells [1, n-2]: the CIC halo never touches
    # the FFT wrap plane
    extent = torch.clamp(torch.amax(hi - lo), min=1.0e-6)
    cell = extent / (n - 3)
    origin = lo - 1.5 * cell
    return origin, cell, cfg.grav_split_rs * cell


def pm_long_range(p: Particles, cfg: SimConfig):
    """Gaussian-filtered long-range gravitational acceleration (CIC-PM).
    Returns (acc [N, 3], origin, cell, r_s); r_s is the split scale the
    short-range pass must complement.  Each call is one solve, counted in
    `pm_long_range.solves`."""
    if cfg.grav_fft == "matmul" and cfg.grav_gradient != "fd":
        raise ValueError("grav_fft='matmul' implements the 'fd' gradient "
                         "only (set grav_gradient='fd' or grav_fft='xla')")
    n = cfg.grav_grid
    npad = 2 * n  # isolated (vacuum) boundaries: zero-pad 2x per axis
    dtype, dev = p.pos.dtype, p.pos.device
    origin, cell, r_s = pm_geometry(p, cfg)

    m = torch.where(p.alive, p.mass, 0.0)
    rho_pad = torch.zeros((npad, npad, npad), dtype=dtype, device=dev)
    rho_pad[:n, :n, :n] = _cic_deposit(p.pos, m, origin, cell, n) / cell ** 3
    rho_k = torch.fft.rfftn(rho_pad)
    del rho_pad
    # the table is K / cell in cell units; the DFT -> integral volume
    # factor cell^3 gives phi_k = rho_k K_k cell^2
    phi_k = rho_k * grav_tables(cfg, dtype, dev) * (cell * cell)
    del rho_k
    shape = (npad, npad, npad)
    if cfg.grav_gradient == "fd":
        grads = _fd4_gradient(torch.fft.irfftn(phi_k, s=shape), cell)
    else:  # exact spectral gradient F(k) = -i k phi(k)
        kx = torch.fft.fftfreq(npad, dtype=dtype, device=dev) * (2.0 * PI)
        kz = torch.fft.rfftfreq(npad, dtype=dtype, device=dev) * (2.0 * PI)
        grads = [torch.fft.irfftn((-1j) * (k / cell) * phi_k, s=shape)
                 for k in (kx[:, None, None], kx[None, :, None],
                           kz[None, None, :])]
    del phi_k
    force = torch.stack([g[:n, :n, :n] for g in grads], dim=-1)
    del grads
    acc = _cic_gather(force, p.pos, origin, cell, n)
    pm_long_range.solves += 1
    return (torch.where(p.alive[:, None], acc.to(dtype), 0.0), origin, cell,
            r_s)


pm_long_range.solves = 0


def erf_approx(x, expmx2):
    """erf(x) for x >= 0 given e^(-x^2): Abramowitz-Stegun 7.1.26 (max abs
    error 1.5e-7), as in the JAX package's short-range paths."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    return 1.0 - poly * expmx2


def _short_factor(r, h_i, r_s):
    """g_short(r) = f_spline(r/h) - S(r): what the mesh didn't deliver."""
    x = r / (2.0 * r_s)
    expmx2 = torch.exp(-x * x)
    s = erf_approx(x, expmx2) - r / (r_s * math.sqrt(PI)) * expmx2
    return grav_softening(r, h_i) - s


def gravity_sort(p: Particles, cfg: SimConfig, r_s):
    """The slim sort of the short-range pass: cell keys at cell = r_cut,
    one stable sort, (x, y, z, m, h) gathered, and the 9 windows of every
    group (`sorted_grid.group_windows`).  Returns (pos [Np, 3], masked
    mass, h, grid, perm, (r_s, r_cut)) in the sorted order, padded with
    dead rows to a multiple of max(sorted_block, 128).  The stable sort
    keeps the pad rows after every row of `p`, so perm[:p.capacity] is a
    permutation of p's rows."""
    r_cut = cfg.effective_rcut_rs() * r_s
    wg = cfg.window_group
    if cfg.sorted_block % wg or LANES % wg:
        raise ValueError(
            f"cfg.window_group ({wg}) must divide both cfg.sorted_block "
            f"({cfg.sorted_block}) and {LANES}")
    pad = _pad_to(p.capacity, max(cfg.sorted_block, LANES)) - p.capacity
    dtype, dev = p.pos.dtype, p.pos.device

    origin = torch.amin(torch.where(p.alive[:, None], p.pos, torch.inf),
                        dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    cell = torch.clamp(torch.as_tensor(r_cut, dtype=dtype, device=dev),
                       min=1.0e-12)
    key = torch.where(p.alive, _cell_key(p.pos, origin, cell), SENTINEL_KEY)

    def padded(a, fill):
        tail = torch.full((pad,) + a.shape[1:], fill, dtype=a.dtype,
                          device=dev)
        return torch.cat([a, tail])

    key_s, perm = torch.sort(padded(key, SENTINEL_KEY), stable=True)
    starts, ends = group_windows(key_s, wg)
    grid = SortedGrid(key=key_s, starts=starts, ends=ends, origin=origin,
                      cell_size=cell,
                      n_clamped=torch.zeros((), dtype=torch.int32,
                                            device=dev))
    return (padded(p.pos, 0.0)[perm],
            padded(torch.where(p.alive, p.mass, 0.0), 0.0)[perm],
            padded(p.h, 1.0)[perm], grid, perm, (r_s, r_cut))


def pm_short_range(p: Particles, cfg: SimConfig, r_s):
    """Direct complementary pair force within r_cut = effective_rcut_rs *
    r_s: the slim gravity sort (`gravity_sort`), the `grav_short` kernel
    (its plain version on the CPU) and a scatter back to p's order.  `p`
    may be in any order; the result matches it.  Returns (acc [N, 3],
    n_window_overflow), the count always 0: the kernel covers every
    group's whole candidate range."""
    pos_s, m_s, h_s, grid, perm, split = gravity_sort(p, cfg, r_s)
    acc_s = torch.stack(grav_short_sums(pos_s, m_s, h_s, grid, cfg, split),
                        dim=-1)
    n0 = p.capacity
    acc = torch.empty_like(p.pos)
    acc[perm[:n0]] = acc_s[:n0].to(acc.dtype)
    return (torch.where(p.alive[:, None], acc, 0.0),
            torch.zeros((), dtype=torch.int32, device=p.pos.device))


def gas_gravity_pm(p: Particles, cfg: SimConfig):
    """Full PM + short-range self-gravity.  Returns (acc, n_window_overflow
    int32, always 0)."""
    acc_long, _, _, r_s = pm_long_range(p, cfg)
    acc_short, n_over = pm_short_range(p, cfg, r_s)
    return acc_long + acc_short, n_over


def recompute_far_field(pm_phase: Optional[int], r_s_held,
                        held_valid: bool = False) -> bool:
    """Whether a step solves the mesh anew (cfg.pm_every).  The phase is a
    host integer: None (a bare `step`, `prime`) or 0 recomputes; so does a
    held split r_s_held <= 0 (a state that never solved).  `held_valid`
    says the caller knows the held force is valid (`run_steps` after its
    phase-0 step); otherwise a nonzero phase reads r_s_held from the
    device, the one case that waits for the card."""
    if pm_phase is None or pm_phase == 0 or r_s_held is None:
        return True
    if held_valid:
        return False
    return not bool(r_s_held > 0.0)


def pm_long_range_held(p: Particles, cfg: SimConfig, pm_phase, r_s_held,
                       held_valid: bool = False):
    """The far-field half of `gas_gravity_pm_held` alone (cfg.grav_fuse_short,
    whose short-range complement runs inside the force kernel).  Returns
    (acc_long, r_s): the held p.acc_ext and r_s_held on held steps, a fresh
    solve otherwise (always when p carries no acc_ext)."""
    if p.acc_ext is not None and not recompute_far_field(
            pm_phase, r_s_held, held_valid):
        return p.acc_ext, r_s_held.to(p.pos.dtype)
    acc_long, _, _, r_s = pm_long_range(p, cfg)
    return acc_long, r_s


def gas_gravity_pm_held(p: Particles, cfg: SimConfig, pm_phase, r_s_held,
                        held_valid: bool = False):
    """PM self-gravity with the long-range force recomputed every
    cfg.pm_every-th step and held in between (`recompute_far_field`
    decides on the host); the short-range complement runs every step at
    the split scale the far field was built with.  Returns (acc,
    n_window_overflow, acc_long, r_s); the caller stores acc_long in
    p.acc_ext and r_s in SimState.pm_r_s."""
    if p.acc_ext is None:
        raise ValueError(
            "gas_gravity_pm_held needs particles.acc_ext (call "
            "integrate.init_carries / prime with cfg.pm_every > 1 first)")
    acc_long, r_s = pm_long_range_held(p, cfg, pm_phase, r_s_held,
                                       held_valid)
    acc_short, n_over = pm_short_range(p, cfg, r_s)
    return acc_long + acc_short, n_over, acc_long, r_s


__all__ = ["PM_MODES", "green_kernel_k", "grav_tables", "pm_geometry",
           "pm_long_range", "gravity_sort", "pm_short_range",
           "gas_gravity_pm",
           "recompute_far_field", "pm_long_range_held",
           "gas_gravity_pm_held", "erf_approx"]
