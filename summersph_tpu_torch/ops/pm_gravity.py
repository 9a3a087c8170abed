"""TreePM self-gravity: the particle-mesh long range and the short-range
pair complement.

Counterpart of `summersph_tpu/ops/pm_gravity.py`, whose docstring gives
the method:

  F_total(r) = F_long(r) + F_short(r)

* F_long (`pm_long_range`): cloud-in-cell deposit on a `grav_grid`^3 mesh
  over the live bounding cube (integer `index_add_`s of a fixed point:
  the same bits on every run), the isolated-boundary (Hockney-Eastwood)
  Poisson solve on the 2x zero-padded grid with
  `torch.fft.rfftn`/`irfftn` and the scale-free Green's table
  (`green_kernel_k`), the force by 4th-order finite differences
  (`grav_gradient='fd'`) or the spectral gradient, and CIC interpolation
  back to the particles.
* F_short (`pm_short_range`): the pair sum of
  g_short(r) = f_spline(r/h_i) - S(r) over 0 < r < r_cut on a slim sort
  with cells r_cut wide, through the `grav_short` CUDA kernel
  (`ops/cuda_pairs.grav_short_sums`).

The mesh is rebuilt from the particles every solve; r_s and r_cut are 0-d
tensors, so nothing in a solve waits for the card.  Whether an evaluation
solves or holds the far field of an earlier solve (cfg.pm_every), and
whether its short range is fused into the force kernel, is decided by the
seam in `ops/gravity.py` (`far_field_plan`, `gas_gravity`).

On several devices (gather mode: `rows` = (p_rows, offset) and
`axis_name`, a `parallel.Mesh`) `p` is the replicated full set, which
sizes the mesh box and is gravity-sorted on every rank alike; each rank
deposits its own rows and the mesh is summed over the ranks, each rank
sums the short range of its 1/D slab of the gravity-sorted rows (the
`grav_short_rows` kernel: a work split, not the caller's rows), scatters
them to p's order, and the [N, 3] partial forces are summed over the
ranks before the caller's rows are sliced out.

Under the slab decomposition (`decomp=True`, `gas_gravity_pm_decomp`) `p`
is a rank's own slab: the box is reduced over the ranks, the rank
deposits its slab, and with grav_fft='matmul' (both packages' default)
the mesh is solved by the pencil solve (`poisson_pencil`, the
counterpart of the JAX package's `mm_dft.poisson_pencil`, with
`torch.fft`): the deposit summed and scattered over x, the transforms'
heavy middle split over ky with two all-to-alls, phi gathered.  Where
the rank count does not tile the mesh (D must divide n and
m_p = 8 ceil((n + 4) / 8)) it falls back to the summed mesh and the
replicated solve, as the JAX package does.  The short range runs whole
(the `grav_short` kernel) on [left rim | own | right rim] with a rim of
cfg.grav_halo_rows rows a hop.  Otherwise `grav_fft='matmul'` (the
TPU's pruned matmul DFT) is accepted as another name for the one
`torch.fft` path.  The short-range kernel walks every
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
from ..parallel.comm import (all_gather_tiled, all_to_all_tiled,
                             axis_index, pmax, pmin, psum, psum_scatter)
from ..parallel.decomp import KX, KY, exchange_rim, rim_short_count
from ..state import Particles
from ..tracing import active, count, span, traced
from ..utils.units import G, PI
from .cuda_pairs import grav_short_sums
from .kernels import grav_softening
from .sorted_grid import (LANES, SENTINEL_KEY, SortedGrid, _cell_key,
                          _pad_to, group_windows, group_worklist)

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


# The deposit sums in integer fixed point: integer addition does not
# depend on its order, while a float `index_add_` on the card is an atomic
# add whose order, and so whose rounding, changes from run to run.  A
# corner's m w, scaled by 2^k so that the deposited mass stays under 2^61,
# splits into its integer part (the high word) and its fraction at 2^-j
# (the low word, j as large as the count of terms lets a cell's sum stay
# under 2^62).
_HIGH_BITS = 61
_MAX_SCALE = 100   # 2^k and 2^-k stay normal float32 numbers


def _pow2(k, dtype):
    """2^k in `dtype` exactly, from the exponent bits (k an integer
    tensor within the float's normal range)."""
    if dtype == torch.float64:
        return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    if dtype == torch.float32:
        return ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    raise TypeError(f"the CIC deposit sums float32 or float64, not {dtype}")


def _cic_deposit(pos, mass, origin, cell, n):
    """CIC (trilinear) mass deposit onto an [n, n, n] mesh: the 8 corners
    of every particle summed by two int64 `index_add_`s of a two-word
    fixed point, so the mesh has the same bits on every run and for every
    order of the rows.  The scale comes from the summed mass on the
    device, with no host read."""
    flat, w = zip(*_cic_corners(pos, origin, cell, n))
    vals = torch.cat([mass * wx for wx in w])
    idx = torch.cat(flat)
    dtype = vals.dtype
    low_bits = 62 - vals.shape[0].bit_length()
    _, e = torch.frexp(torch.sum(torch.abs(mass)))
    k = torch.clamp(_HIGH_BITS - e, -_MAX_SCALE, _MAX_SCALE)
    y = vals * _pow2(k, dtype)
    high = torch.floor(y)
    low = torch.round((y - high) * 2.0 ** low_bits)
    acc_high = torch.zeros(n * n * n, dtype=torch.int64, device=vals.device)
    acc_low = torch.zeros_like(acc_high)
    acc_high.index_add_(0, idx, high.to(torch.int64))
    acc_low.index_add_(0, idx, low.to(torch.int64))
    rho = ((acc_high.to(dtype) + acc_low.to(dtype) * 2.0 ** -low_bits)
           * _pow2(-k, dtype))
    return rho.reshape(n, n, n)


def _cic_gather(field, pos, origin, cell, n):
    """CIC interpolation of an [n, n, n, 3] field to particle positions."""
    flat_field = field.reshape(n * n * n, 3)
    out = torch.zeros((pos.shape[0], 3), dtype=field.dtype,
                      device=field.device)
    for flat, w in _cic_corners(pos, origin, cell, n):
        out = out + w[:, None] * flat_field[flat]
    return out


def _phi_k(rho, cfg: SimConfig, cell, npad: int):
    """The potential's rfft over the zero-padded (npad^3) mesh: the pad,
    the forward transform and the product with the Green's function."""
    n = rho.shape[0]
    rho_pad = torch.zeros((npad, npad, npad), dtype=rho.dtype,
                          device=rho.device)
    rho_pad[:n, :n, :n] = rho
    rho_k = torch.fft.rfftn(rho_pad)
    del rho_pad
    # the table is K / cell in cell units; the DFT -> integral volume
    # factor cell^3 gives phi_k = rho_k K_k cell^2
    return rho_k * grav_tables(cfg, rho.dtype, rho.device) * (cell * cell)


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


def pm_geometry(p: Particles, cfg: SimConfig, axis_name=None,
                decomp: bool = False):
    """(origin [3], cell, r_s): the mesh box over the live bounding cube
    and the Gaussian split scale, as 0-d tensors.  Deterministic in the
    particles, so a caller that needs r_s before the long-range solve (the
    fused force kernel) gets the value `pm_long_range` will use.  With
    `decomp` `p` is a rank's slab and the box bounds the live particles
    of every rank of `axis_name`."""
    n = cfg.grav_grid
    alive3 = p.alive[:, None]
    lo = torch.amin(torch.where(alive3, p.pos, torch.inf), dim=0)
    hi = torch.amax(torch.where(alive3, p.pos, -torch.inf), dim=0)
    if decomp:
        lo, hi = pmin(lo, axis_name), pmax(hi, axis_name)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    # all particles in mesh cells [1, n-2]: the CIC halo never touches
    # the FFT wrap plane
    extent = torch.clamp(torch.amax(hi - lo), min=1.0e-6)
    cell = extent / (n - 3)
    origin = lo - 1.5 * cell
    return origin, cell, cfg.grav_split_rs * cell


def _ghost_crop(n: int) -> int:
    """m_p: the n + 4 rows of the mesh crop and the fd4 stencil's ghost
    ring, padded to a multiple of 8 (the JAX package's `ci_p` tables), so
    that the pencil solve can split them over 2, 4 or 8 ranks."""
    return -(-(n + 4) // 8) * 8


def pencil_tiles(n: int, n_ranks: int) -> bool:
    """Whether the pencil solve splits a grid of n over n_ranks ranks: the
    deposit's x planes (n) and the ghost-cropped rows (m_p) must both
    divide, as in the JAX package."""
    return n % n_ranks == 0 and _ghost_crop(n) % n_ranks == 0


def poisson_pencil(rho_local: torch.Tensor, kern_k: torch.Tensor, scale,
                   mesh) -> torch.Tensor:
    """The isolated-boundary Poisson solve of the mesh summed over the
    ranks, with the transforms split over them (the JAX package's
    `mm_dft.poisson_pencil`, in `torch.fft`).  Every rank holds its own
    deposit `rho_local` [n, n, n]; returns phi_m [m, m, m], m = n + 4,
    the same on every rank: phi on the crop and the fd4 stencil's ghost
    ring, phi_m[a] = phi[(a - 2) mod npad] on every axis.

      psum_scatter over x     [n / D, n, n] summed planes of this rank
      z (rfft) and y (fft)    [n / D, npad, H], zero-padded to npad
      all-to-all x <-> ky     [n, npad / D, H]
      x (fft), Green's table of this ky block x scale, inverse x
      ghost-crop rows         [m_p, npad / D, H]
      all-to-all back         [m_p / D, npad, H]
      inverse y, z (irfft)    [m_p / D, m, m], ghost-cropped
      all-gather              [m_p, m, m], then the first m

    The transforms and the spectrum split 1/D over the ranks; the deposit
    sum and the phi gather stay O(n^3) bytes, as the summed mesh they
    replace."""
    n = rho_local.shape[0]
    npad, D = 2 * n, mesh.size
    m, m_p = n + 4, _ghost_crop(n)
    ghost = (torch.arange(m_p, device=rho_local.device) - 2) % npad
    f = psum_scatter(rho_local, mesh)
    f = torch.fft.fft(torch.fft.rfft(f, n=npad, dim=2), n=npad, dim=1)
    f = all_to_all_tiled(f, mesh, split_dim=1, concat_dim=0)
    f = torch.fft.fft(f, n=npad, dim=0)
    b = npad // D
    f = f * (kern_k[:, mesh.rank * b:(mesh.rank + 1) * b] * scale)
    f = torch.fft.ifft(f, dim=0)[ghost]
    f = all_to_all_tiled(f, mesh, split_dim=0, concat_dim=1)
    f = torch.fft.ifft(f, dim=1)[:, ghost[:m]]
    phi = torch.fft.irfft(f, n=npad, dim=2)[:, :, ghost[:m]]
    return all_gather_tiled(phi.contiguous(), mesh)[:m]


def _fd4_gradient_pruned(phi_m, cell, n: int):
    """F = -grad phi by 4th-order central differences on the ghost-ringed
    m-cube of `poisson_pencil`: output j reads phi_m[j .. j + 4] on its
    axis.  Returns (gx, gy, gz), each [n, n, n]."""
    inv12c = 1.0 / (12.0 * cell)

    def d(axis):
        def sl(lo):
            idx = [slice(2, 2 + n)] * 3
            idx[axis] = slice(lo, lo + n)
            return phi_m[tuple(idx)]
        return (-sl(4) + 8.0 * sl(3) - 8.0 * sl(1) + sl(0)) * inv12c

    return [-d(0), -d(1), -d(2)]


@traced("pm_long_range")
def pm_long_range(p: Particles, cfg: SimConfig, rows=None, axis_name=None,
                  decomp: bool = False):
    """Gaussian-filtered long-range gravitational acceleration (CIC-PM).
    Returns (acc [N, 3], origin, cell, r_s); r_s is the split scale the
    short-range pass must complement.  Each call is one solve, counted in
    `pm_long_range.solves` (and those of the pencil solve also in
    `pm_long_range.pencil_solves`).  With `rows` = (p_rows, offset) and
    `axis_name` the box comes from the full set `p`, this rank deposits
    p_rows, the mesh is summed over the ranks, and acc is p_rows's.  With
    `decomp` and `axis_name` (the slab decomposition) `p` is this rank's
    slab: the box is reduced over the ranks, and with grav_fft='matmul'
    the mesh is solved by `poisson_pencil` where `pencil_tiles` holds.

    Its four child spans cover the whole solve: `pm_deposit` (the box, the
    CIC deposit, the sum over the ranks), `pm_poisson` (the zero pad, the
    forward transform, the Green's product and, with the fd gradient, the
    inverse; the pencil solve whole), `pm_gradient` (the fd gradient and
    the crop; with the spectral gradient also its three inverse
    transforms) and `pm_gather` (the CIC interpolation to the
    particles)."""
    if cfg.grav_fft == "matmul" and cfg.grav_gradient != "fd":
        raise ValueError("grav_fft='matmul' implements the 'fd' gradient "
                         "only (set grav_gradient='fd' or grav_fft='xla')")
    n = cfg.grav_grid
    npad = 2 * n  # isolated (vacuum) boundaries: zero-pad 2x per axis
    dtype, dev = p.pos.dtype, p.pos.device
    p_dep = p if rows is None else rows[0]
    pencil = (decomp and axis_name is not None and cfg.grav_fft == "matmul"
              and pencil_tiles(n, axis_name.size))
    with span("pm_deposit"):
        origin, cell, r_s = pm_geometry(p, cfg, axis_name, decomp)
        m = torch.where(p_dep.alive, p_dep.mass, 0.0)
        rho = _cic_deposit(p_dep.pos, m, origin, cell, n) / cell ** 3
        if axis_name is not None and not pencil:
            rho = psum(rho, axis_name)
    if pencil:
        with span("pm_poisson"):
            phi_m = poisson_pencil(rho, grav_tables(cfg, dtype, dev),
                                   cell * cell, axis_name)
        with span("pm_gradient"):
            force = torch.stack(_fd4_gradient_pruned(phi_m, cell, n), dim=-1)
        pm_long_range.pencil_solves += 1
    elif cfg.grav_gradient == "fd":
        with span("pm_poisson"):
            phi = torch.fft.irfftn(_phi_k(rho, cfg, cell, npad),
                                   s=(npad,) * 3)
        with span("pm_gradient"):
            grads = _fd4_gradient(phi, cell)
            del phi
            force = torch.stack([g[:n, :n, :n] for g in grads], dim=-1)
            del grads
    else:  # exact spectral gradient F(k) = -i k phi(k)
        with span("pm_poisson"):
            phi_k = _phi_k(rho, cfg, cell, npad)
        with span("pm_gradient"):
            kx = torch.fft.fftfreq(npad, dtype=dtype, device=dev) * (2.0 * PI)
            kz = torch.fft.rfftfreq(npad, dtype=dtype, device=dev) * (2.0 * PI)
            grads = [torch.fft.irfftn((-1j) * (k / cell) * phi_k,
                                      s=(npad,) * 3)
                     for k in (kx[:, None, None], kx[None, :, None],
                               kz[None, None, :])]
            del phi_k
            force = torch.stack([g[:n, :n, :n] for g in grads], dim=-1)
            del grads
    with span("pm_gather"):
        acc = _cic_gather(force, p_dep.pos, origin, cell, n)
        acc = torch.where(p_dep.alive[:, None], acc.to(dtype), 0.0)
    pm_long_range.solves += 1
    return acc, origin, cell, r_s


pm_long_range.solves = 0
pm_long_range.pencil_solves = 0


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


@traced("grav_sort")
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
    if active():
        count("grav_candidates",
              torch.sum(ends - starts, dtype=torch.int64) * wg)
        count("grav_rows", torch.sum(p.alive))
    grid = SortedGrid(key=key_s, starts=starts, ends=ends, origin=origin,
                      cell_size=cell,
                      n_clamped=torch.zeros((), dtype=torch.int32,
                                            device=dev))
    return (padded(p.pos, 0.0)[perm],
            padded(torch.where(p.alive, p.mass, 0.0), 0.0)[perm],
            padded(p.h, 1.0)[perm], grid, perm, (r_s, r_cut))


@traced("grav_short")
def pm_short_range(p: Particles, cfg: SimConfig, r_s, rows=None,
                   axis_name=None, active_rows=None):
    """Direct complementary pair force within r_cut = effective_rcut_rs *
    r_s: the slim gravity sort (`gravity_sort`), the `grav_short` kernel
    (its plain version on the CPU) and a scatter back to p's order.  `p`
    may be in any order; the result matches it.  Returns (acc [N, 3],
    n_window_overflow), the count always 0: the kernel covers every
    group's whole candidate range.

    With `rows` = (p_rows, offset) and `axis_name` (gather mode) this rank
    sums its 1/D slab of the gravity-sorted rows (`grav_short_rows`), the
    scattered partial forces are summed over the ranks, and acc is the
    rows [offset, offset + p_rows.capacity) of p's order.

    `active_rows` [N] bool (block timesteps, one device) rides the gravity
    sort; a worklist over the window groups of that order, not of p's,
    gates the kernel (`grav_short_gated`), and inactive rows return
    exactly 0."""
    if active_rows is not None and rows is not None:
        raise ValueError("pm_short_range: active_rows gating is "
                         "single-device")
    pos_s, m_s, h_s, grid, perm, split = gravity_sort(p, cfg, r_s)
    cap = perm.shape[0]
    gate = act_s = slab = None
    off_g, nloc = 0, cap
    if active_rows is not None:
        pad = active_rows.new_zeros(cap - p.capacity)
        act_s = torch.cat([active_rows, pad])[perm]
        gate = group_worklist(act_s, cfg.window_group)
    if rows is not None:
        nloc = cap // (p.capacity // rows[0].capacity)
        if nloc % cfg.window_group:
            raise ValueError(
                f"sharded PM gravity needs the padded capacity ({cap}) to "
                f"split into window groups of {cfg.window_group} per rank")
        off_g = axis_index(axis_name) * nloc
        slab = (off_g, nloc)
    acc_s = torch.stack(grav_short_sums(pos_s, m_s, h_s, grid, cfg, split,
                                        gate, slab), dim=-1)
    if act_s is not None:
        acc_s = torch.where(act_s[:, None], acc_s, 0.0)
    # scatter to p's order; the pad rows of the sort land past p's rows
    acc = p.pos.new_zeros((cap, 3))
    acc[perm[off_g:off_g + nloc]] = acc_s.to(acc.dtype)
    acc = acc[:p.capacity]
    n_over = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    if rows is None:
        return torch.where(p.alive[:, None], acc, 0.0), n_over
    p_rows, offset = rows
    acc = psum(acc, axis_name)[offset:offset + p_rows.capacity]
    return torch.where(p_rows.alive[:, None], acc, 0.0), n_over


def gas_gravity_pm(p: Particles, cfg: SimConfig, rows=None, axis_name=None):
    """Full PM + short-range self-gravity; with `rows` and `axis_name` the
    sharded form of both (see `pm_long_range`, `pm_short_range`).  Returns
    (acc, n_window_overflow int32, always 0)."""
    acc_long, _, _, r_s = pm_long_range(p, cfg, rows, axis_name)
    acc_short, n_over = pm_short_range(p, cfg, r_s, rows, axis_name)
    return acc_long + acc_short, n_over


def gas_gravity_pm_decomp(p_own: Particles, key_own, cell_sph,
                          cfg: SimConfig, mesh):
    """PM + short-range self-gravity under the slab decomposition.  The
    long range: `pm_long_range` with decomp (the box over the ranks, this
    slab's deposit, the pencil solve or the summed mesh), back at the own
    rows.  The short range reaches r_cut, further than the SPH stencil, so
    a wider rim (cfg.grav_halo_rows rows a hop, in the same SPH rank
    space: a ball maps into a contiguous key and rank interval) is
    exchanged, and `pm_short_range` runs whole on [left rim | own | right
    rim] (its own slim sort and the whole-set `grav_short` kernel); the
    own rows of its result are this slab's short-range force, provided the
    rims covered the reach.  Own rows whose r_cut reach, ceil(r_cut /
    cell_sph) + 1 SPH cells an axis, outran a truncated rim are counted in
    rim_short, for the caller's decomp_pressure.  Returns (acc [nloc, 3],
    n_window_overflow (0), rim_short).

    The own rows start after the whole left rim, hops x grav_halo_rows
    rows; the JAX package reads them from row grav_halo_rows on, which is
    the left rim's length only at halo_hops = 1 (ROADMAP.md C)."""
    acc_long, _, _, r_s = pm_long_range(p_own, cfg, axis_name=mesh,
                                        decomp=True)
    nloc = p_own.capacity
    rim_l, rim_r = exchange_rim(key_own, p_own, mesh, cfg.grav_halo_rows,
                                fields=("pos", "mass", "h"),
                                hops=cfg.halo_hops)

    def cat(f):
        return torch.cat([rim_l[f], getattr(p_own, f), rim_r[f]])

    key_c = torch.cat([rim_l["key"], key_own, rim_r["key"]])
    alive_c = key_c != SENTINEL_KEY
    pg = Particles.zeros(key_c.shape[0], p_own.pos.dtype,
                         p_own.pos.device).replace(
        pos=cat("pos"), mass=cat("mass"),
        h=torch.where(alive_c, cat("h"), 1.0), alive=alive_c)
    acc_all, n_over = pm_short_range(pg, cfg, r_s)
    lo = rim_l["key"].shape[0]
    acc_short = acc_all[lo:lo + nloc]

    r_cut = cfg.effective_rcut_rs() * r_s
    c_cells = torch.ceil(r_cut / torch.clamp(cell_sph, min=1.0e-12)
                         ).to(torch.int32) + 1
    reach = c_cells * (KX + KY + 1)
    rim_short = rim_short_count(key_own, rim_l, rim_r, key_own - reach,
                                key_own + reach)
    acc = acc_long + torch.where(p_own.alive[:, None], acc_short, 0.0)
    return acc, n_over, rim_short


def recompute_far_field(pm_phase: Optional[int], r_s_held,
                        held_valid: bool = False) -> bool:
    """Whether a step solves the mesh anew (cfg.pm_every; the seam,
    `ops.gravity.far_field_plan`, asks).  The phase is a host integer:
    None (a bare `step`, `prime`) or 0 recomputes; so does a held split
    r_s_held <= 0 (a state that never solved).  `held_valid` says the
    caller knows the held force is valid (`run_steps` after its phase-0
    step); otherwise a nonzero phase reads r_s_held from the device, the
    one case that waits for the card."""
    if pm_phase is None or pm_phase == 0 or r_s_held is None:
        return True
    if held_valid:
        return False
    return not bool(r_s_held > 0.0)


__all__ = ["PM_MODES", "green_kernel_k", "grav_tables", "pm_geometry",
           "pm_long_range", "gravity_sort", "pm_short_range",
           "gas_gravity_pm", "gas_gravity_pm_decomp", "poisson_pencil",
           "pencil_tiles", "recompute_far_field", "erf_approx"]
