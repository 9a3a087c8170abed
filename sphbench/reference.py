"""The plain reference: one KDK step of the SPH engine in plain torch.

It imports nothing of the program.  It states the physics the program's
step computes, from the same initial state, so that what the timed path
produces can be held against it: the configuration's fields (a plain
dict, the `sim` block of `configs/<name>.json`) and a state (a dict of
tensors, `state_from_program` in `compare.py`) go in, the state after
`steps` steps comes out.  Every layer of the step is here:

* the cell grid of the step (origin at the live minimum, cells of side
  2 h_cell h_pad, h_cell the largest live h or its `cell_h_quantile`) and
  the 27-cell stencil, outside which no pair is summed;
* density with the analytic self term and the grad-h Omega (variable h),
  the ideal-gas EOS;
* the pressure and Monaghan viscosity forces, du/dt, and the
  Morris-Monaghan alpha switch;
* TreePM self-gravity: the CIC deposit, the isolated Poisson solve on the
  2x padded mesh with the erf-split Green's function, the 4th-order
  gradient, the CIC gather, held for `pm_every` steps; the short-range
  complement f(r/h_i) - S(r) over every pair with r < r_cut;
* direct sink gravity, sink creation, accretion onto the nearest sink,
  sink merging, the bounds cull;
* the kicks and the drift (Kahan-compensated u when `kahan_u`), the
  adaptive timestep with hysteresis, and the Newton h-iteration.

Sums run as scatter-adds over explicit pair lists (`pairs.CellGrid`);
nothing is sorted into the program's order.  The precision is the
`dtype` of the state; the FFT runs in float32 when that is bfloat16,
which cuFFT does not take.
"""

from __future__ import annotations

import math

import torch

from .pairs import CellGrid

G = 39.47841760435743      # AU^3 / (M_sun yr^2)
PI = math.pi
PARK = 1.0e12
PAIR_BLOCK = 1 << 25       # pairs per block of the pair arithmetic
PM_MODES = ("bh", "pm", "treepm")


# ------------------------------------------------------------------ kernel

def w_shape(q):
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q
    outer = 0.25 * (2.0 - q) ** 3
    return torch.where(q <= 1.0, inner,
                       torch.where(q <= 2.0, outer, torch.zeros_like(q)))


def dw_shape(q):
    inner = -3.0 * q + 2.25 * q * q
    outer = -0.75 * (2.0 - q) ** 2
    return torch.where(q <= 1.0, inner,
                       torch.where(q <= 2.0, outer, torch.zeros_like(q)))


def grav_shape(q):
    """Spline softening f(q) of G M / r^2; 1 beyond q = 2."""
    q2 = q * q
    q3 = q2 * q
    inner = (40.0 * q3 - 36.0 * q3 * q2 + 15.0 * q3 * q3) / 30.0
    outer = (80.0 * q3 - 90.0 * q2 * q2 + 36.0 * q3 * q2 - 5.0 * q3 * q3
             - 2.0) / 30.0
    return torch.where(q <= 1.0, inner,
                       torch.where(q <= 2.0, outer, torch.ones_like(q)))


def _blocks(n):
    for a in range(0, n, PAIR_BLOCK):
        yield a, min(a + PAIR_BLOCK, n)


# ------------------------------------------------------------------- grid

def sph_grid(st, sim):
    """The step's cell grid: (origin, cell) with the program's rules."""
    pos, h, alive = st["pos"], st["h"], st["alive"]
    dtype = pos.dtype
    origin = torch.amin(torch.where(alive[:, None], pos, torch.inf), dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    var = sim["fixed_h"] is None
    h_pad = sim["sort_h_pad"] if var else 1.0
    if sim["neighbor_mode"] == "grid" and var:
        h_pad = 1.25
    q = 1.0 if sim["neighbor_mode"] == "grid" else sim["cell_h_quantile"]
    if q >= 1.0:
        h_cell = torch.amax(torch.where(alive, h, 0.0))
    else:
        n = h.shape[0]
        hs = torch.sort(torch.where(alive, h, 0.0)).values
        n_live = int(torch.sum(alive))
        # the quantile's index: q (n_live - 1) rounded down, in float32
        k = int(torch.tensor(q, dtype=torch.float32)
                * torch.tensor(max(n_live - 1, 0), dtype=torch.float32))
        h_cell = hs[min(max(n - n_live + k, 0), n - 1)]
    cell = torch.clamp(2.0 * h_cell * h_pad, min=1.0e-12)
    return origin, cell


# --------------------------------------------------------------- SPH sums

def density(st, pi, pj, h, var):
    """(rho, omega) at smoothing lengths `h` over the pairs (pi, pj):
    the neighbour sums, the self term and the grad-h correction."""
    pos, alive = st["pos"], st["alive"]
    n, dtype = pos.shape[0], pos.dtype
    m_all = torch.where(alive, st["mass"], 0.0)
    rho = torch.zeros(n, dtype=dtype, device=pos.device)
    om = torch.zeros_like(rho)
    for a, b in _blocks(pi.shape[0]):
        i, j = pi[a:b], pj[a:b]
        d = pos[i] - pos[j]
        r = torch.sqrt(torch.sum(d * d, dim=1))
        hi = h[i]
        q = r / hi
        w = w_shape(q)
        inv_pih3 = 1.0 / (PI * hi * hi * hi)
        rho.index_add_(0, i, m_all[j] * w * inv_pih3)
        if var:
            om.index_add_(0, i, -m_all[j] * (3.0 * w + q * dw_shape(q))
                          * inv_pih3 / hi)
    m = st["mass"]
    inv_h3 = 1.0 / (PI * h * h * h)
    rho = rho + m * inv_h3
    om = om - 3.0 * m * inv_h3 / h
    ok = alive & (rho > 0.0)
    rho = torch.where(ok, rho, 1.0)
    if not var:
        return rho, torch.ones_like(rho)
    omega = 1.0 + (h / (3.0 * rho)) * torch.where(ok, om, 0.0)
    omega = torch.where(torch.abs(omega) > 1.0e-4, omega, 1.0)
    return rho, omega


def eos(u, rho, alive, gamma):
    rho = torch.where(alive, rho, 1.0)
    u = torch.where(alive, torch.clamp(u, min=0.0), 0.0)
    p = (gamma - 1.0) * u * rho
    cs = torch.sqrt(gamma * p / rho)
    return torch.where(alive, p, 0.0), torch.where(alive, cs, 0.0)


def forces(st, pi, pj, sim, var):
    """(acc [N, 3], du, alpha_raw) of pressure and viscosity."""
    pos, vel, h = st["pos"], st["vel"], st["h"]
    n, dtype = pos.shape[0], pos.dtype
    alive = st["alive"]
    m_all = torch.where(alive, st["mass"], 0.0)
    rho, om, pres = st["rho"], st["omega"], st["pressure"]
    pterm = pres / torch.clamp(om * rho * rho, min=1.0e-30)
    acc = torch.zeros((n, 3), dtype=dtype, device=pos.device)
    du = torch.zeros(n, dtype=dtype, device=pos.device)
    araw = torch.zeros_like(du)
    for a, b in _blocks(pi.shape[0]):
        i, j = pi[a:b], pj[a:b]
        d = pos[i] - pos[j]
        r2 = torch.sum(d * d, dim=1)
        r = torch.sqrt(r2)
        hi, hj = h[i], h[j]
        dw_i = dw_shape(r / hi) / (PI * hi ** 4)
        if var:
            dw_j = dw_shape(r / hj) / (PI * hj ** 4)
            hbar = 0.5 * (hi + hj)
        else:
            dw_j, hbar = dw_i, hi
        dwbar = 0.5 * (dw_i + dw_j)
        dv = vel[i] - vel[j]
        vdotr = torch.sum(dv * d, dim=1)
        mu = hbar * torch.clamp(vdotr, max=0.0) / (
            r2 + sim["av_eps"] * hbar * hbar)
        cbar = 0.5 * (st["cs"][i] + st["cs"][j])
        abar = 0.5 * (st["alpha"][i] + st["alpha"][j])
        rhobar = 0.5 * (rho[i] + rho[j])
        visc = ((-abar * cbar * mu + sim["beta_factor"] * abar * mu * mu)
                / torch.clamp(rhobar, min=1.0e-30))
        mj = m_all[j]
        scal = pterm[i] * dw_i + pterm[j] * dw_j + visc * dwbar
        coef = -mj * scal / r
        acc.index_add_(0, i, coef[:, None] * d)
        vgw = vdotr / r * dwbar
        du.index_add_(0, i, mj * vgw * (pterm[i] + 0.5 * visc))
        araw.index_add_(0, i, mj * vgw)
    return acc, du, araw


def alpha_rate(araw, rho, alpha, cs, h, sim):
    src = torch.clamp(araw / torch.where(rho > 0.0, rho, 1.0), min=0.0)
    return src + sim["alpha_decay"] * (sim["alpha_min"] - alpha) * cs / h


# ---------------------------------------------------------------- gravity

def _green_k(npad, rs, dtype, device):
    """k-space isolated Green's function of -G erf(q / 2 r_s) / q (cell
    units) on the padded grid, CIC window deconvolved twice."""
    f64 = torch.float64
    idx = torch.arange(npad, dtype=f64, device=device)
    d1 = torch.where(idx <= npad // 2, idx, idx - npad)
    q = torch.sqrt(d1[:, None, None] ** 2 + d1[None, :, None] ** 2
                   + d1[None, None, :] ** 2)
    kq = -G * torch.special.erf(q / (2.0 * rs)) / torch.clamp(q, min=1e-30)
    kq[0, 0, 0] = -G / (rs * math.sqrt(PI))
    table = torch.fft.rfftn(kq).real
    del kq, q

    def sinc2(x):
        s = torch.where(torch.abs(x) > 1e-6,
                        torch.sin(x) / torch.where(x == 0, 1.0, x), 1.0)
        return s * s

    wx = sinc2(torch.fft.fftfreq(npad, dtype=f64, device=device) * PI)
    wz = sinc2(torch.fft.rfftfreq(npad, dtype=f64, device=device) * PI)
    w = wx[:, None, None] * wx[None, :, None] * wz[None, None, :]
    return (table / torch.clamp(w * w, min=0.05)).to(dtype)


def _cic(pos, origin, cell, n):
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


def pm_geometry(st, sim):
    """(origin, cell, r_s) of the mesh: the live bounding cube, every
    particle in cells [1, n - 2], and the split scale."""
    pos, alive = st["pos"], st["alive"]
    n = sim["grav_grid"]
    lo = torch.amin(torch.where(alive[:, None], pos, torch.inf), dim=0)
    hi = torch.amax(torch.where(alive[:, None], pos, -torch.inf), dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    cell = torch.clamp(torch.amax(hi - lo), min=1.0e-6) / (n - 3)
    return lo - 1.5 * cell, cell, sim["grav_split_rs"] * cell


def pm_long(st, sim, green):
    """(acc_long [N, 3], r_s): the CIC-PM far field of one solve."""
    pos, alive = st["pos"], st["alive"]
    dtype = pos.dtype
    n = sim["grav_grid"]
    npad = 2 * n
    origin, cell, r_s = pm_geometry(st, sim)
    m = torch.where(alive, st["mass"], 0.0)
    mesh = torch.zeros(n * n * n, dtype=dtype, device=pos.device)
    for flat, w in _cic(pos, origin, cell, n):
        mesh.index_add_(0, flat, m * w)
    fft_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    rho = (mesh / cell ** 3).reshape(n, n, n).to(fft_dtype)
    pad = torch.zeros((npad,) * 3, dtype=fft_dtype, device=pos.device)
    pad[:n, :n, :n] = rho
    phi_k = torch.fft.rfftn(pad) * green.to(fft_dtype) * (cell * cell).to(
        fft_dtype)
    phi = torch.fft.irfftn(phi_k, s=(npad,) * 3).to(dtype)
    del pad, phi_k
    comps = []
    for ax in range(3):
        dphi = (-torch.roll(phi, -2, ax) + 8.0 * torch.roll(phi, -1, ax)
                - 8.0 * torch.roll(phi, 1, ax) + torch.roll(phi, 2, ax)) \
            / (12.0 * cell)
        comps.append(-dphi[:n, :n, :n].reshape(-1))
    acc = torch.zeros_like(pos)
    for flat, w in _cic(pos, origin, cell, n):
        acc = acc + w[:, None] * torch.stack([c[flat] for c in comps], 1)
    return torch.where(alive[:, None], acc, 0.0), r_s


def rcut_rs(sim):
    if sim["grav_rcut_rs"] is not None:
        return float(sim["grav_rcut_rs"])
    return min(max(2.25 / max(float(sim["theta"]), 1e-3), 3.0), 8.0)


def gravity_grid(st, r_cut):
    """A cell grid for the pairs within r_cut: cells of r_cut / 2 and a
    5^3 stencil, which holds every such pair."""
    pos, alive = st["pos"], st["alive"]
    origin = torch.amin(torch.where(alive[:, None], pos, torch.inf), dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    return CellGrid(pos, alive, origin, r_cut / 2.0, reach=2)


def pm_short(st, r_s, r_cut):
    """Short-range complement -G m_j [f(r / h_i) - S(r)] r / r^3 over every
    pair with 0 < r < r_cut."""
    pos, alive, h = st["pos"], st["alive"], st["h"]
    m_all = torch.where(alive, st["mass"], 0.0)
    grid = gravity_grid(st, r_cut)
    acc = torch.zeros_like(pos)
    rc2 = r_cut * r_cut
    for i, j in grid.candidate_chunks():
        d = pos[i] - pos[j]
        r2 = torch.sum(d * d, dim=1)
        ok = (r2 > 0.0) & (r2 < rc2)
        i, j, d, r2 = i[ok], j[ok], d[ok], r2[ok]
        r = torch.sqrt(r2)
        x = r / (2.0 * r_s)
        ex = torch.exp(-x * x)
        s = torch.special.erf(x) - r / (r_s * math.sqrt(PI)) * ex
        g = grav_shape(r / h[i]) - s
        coef = -G * m_all[j] * g / (r2 * r)
        acc.index_add_(0, i, coef[:, None] * d)
    return torch.where(alive[:, None], acc, 0.0)


def sink_gravity(st, col_block=1 << 18):
    """(acc_gas [N, 3], acc_sink [S, 3]), unsoftened, with sink-sink."""
    pos, alive = st["pos"], st["alive"]
    spos, salive, smass = st["spos"], st["salive"], st["smass"]
    m = torch.where(alive, st["mass"], 0.0)
    acc_gas = torch.zeros_like(pos)
    acc_sink = torch.zeros_like(spos)
    for a in range(0, pos.shape[0], col_block):
        b = min(a + col_block, pos.shape[0])
        d = spos[:, None, :] - pos[None, a:b, :]             # [S, n, 3]
        r2 = torch.sum(d * d, dim=-1)
        ok = alive[None, a:b] & salive[:, None] & (r2 > 0.0)
        w = torch.where(ok, G / (torch.where(ok, r2, 1.0) ** 1.5), 0.0)
        acc_gas[a:b] = torch.sum((w * smass[:, None])[..., None] * d, dim=0)
        acc_sink -= torch.sum((w * m[None, a:b])[..., None] * d, dim=1)
    ds = spos[:, None, :] - spos[None, :, :]
    r2s = torch.sum(ds * ds, dim=-1)
    ok = salive[:, None] & salive[None, :] & (r2s > 0.0)
    ws = torch.where(ok, G / torch.where(ok, r2s, 1.0) ** 1.5, 0.0)
    acc_ss = -torch.sum((ws * smass[None, :])[..., None] * ds, dim=1)
    return (torch.where(alive[:, None], acc_gas, 0.0),
            torch.where(salive[:, None], acc_sink + acc_ss, 0.0))


# ------------------------------------------------------------------ sinks

def _sink_d2(st, a, b):
    d = st["spos"][:, None, :] - st["pos"][None, a:b, :]
    return torch.sum(d * d, dim=-1)


def accrete(st, col_block=1 << 18):
    """Live gas inside a sink's radius goes to the nearest such sink, which
    takes its mass, momentum, centre of mass and angular momentum."""
    S = st["smass"].shape[0]
    n = st["pos"].shape[0]
    dtype = st["pos"].dtype
    dev = st["pos"].device
    msum = torch.zeros(S, dtype=dtype, device=dev)
    psum = torch.zeros((S, 3), dtype=dtype, device=dev)
    xsum = torch.zeros((S, 3), dtype=dtype, device=dev)
    lsum = torch.zeros((S, 3), dtype=dtype, device=dev)
    gone = torch.zeros(n, dtype=torch.bool, device=dev)
    rad2 = st["sradius"] * st["sradius"]
    for a in range(0, n, col_block):
        b = min(a + col_block, n)
        d2 = _sink_d2(st, a, b)
        elig = (st["alive"][None, a:b] & st["salive"][:, None]
                & (st["smass"][:, None] > 0.0) & (d2 < rad2[:, None]))
        took = torch.any(elig, dim=0)
        if not bool(torch.any(took)):
            continue
        cols = torch.nonzero(took)[:, 0]
        near = torch.argmin(torch.where(elig[:, cols], d2[:, cols],
                                        torch.inf), dim=0)
        k = cols + a
        m = st["mass"][k]
        x, v = st["pos"][k], st["vel"][k]
        msum.index_add_(0, near, m)
        psum.index_add_(0, near, m[:, None] * v)
        xsum.index_add_(0, near, m[:, None] * x)
        rx = x - st["spos"][near]
        rv = v - st["svel"][near]
        lsum.index_add_(0, near, m[:, None] * torch.linalg.cross(rx, rv))
        gone[k] = True
    new_m = st["smass"] + msum
    grew = msum > 0.0
    inv = torch.where(grew, 1.0 / torch.where(grew, new_m, 1.0), 0.0)
    out = dict(st)
    out["spos"] = torch.where(grew[:, None], (st["smass"][:, None]
                                               * st["spos"] + xsum)
                              * inv[:, None], st["spos"])
    out["svel"] = torch.where(grew[:, None], (st["smass"][:, None]
                                               * st["svel"] + psum)
                              * inv[:, None], st["svel"])
    out["smass"] = new_m
    out["sspin"] = st["sspin"] + lsum
    return _kill(out, gone)


def _kill(st, gone):
    out = dict(st)
    out["alive"] = st["alive"] & ~gone
    out["mass"] = torch.where(gone, 0.0, st["mass"])
    out["pos"] = torch.where(gone[:, None], PARK, st["pos"])
    out["vel"] = torch.where(gone[:, None], 0.0, st["vel"])
    return out


def create_sink(st, sim, col_block=1 << 18):
    """A sink at the densest live particle with m (eta / h)^3 above the
    threshold and no real sink within radius + 2 h; at most one a step,
    in the first free slot."""
    cd = st["mass"] * (sim["eta"] / st["h"]) ** 3
    real = st["salive"] & (st["smass"] > 0.0)
    near = torch.zeros_like(st["alive"])
    n = st["pos"].shape[0]
    for a in range(0, n, col_block):
        b = min(a + col_block, n)
        reach = st["sradius"][:, None] + 2.0 * st["h"][None, a:b]
        near[a:b] = torch.any(real[:, None]
                              & (_sink_d2(st, a, b) < reach * reach), dim=0)
    elig = st["alive"] & (cd > sim["sink_create_density"]) & ~near
    free = ~st["salive"]
    if not bool(torch.any(elig)) or not bool(torch.any(free)):
        return st
    best = int(torch.argmax(torch.where(elig, cd, -torch.inf)))
    slot = int(torch.argmax(free.to(torch.int32)))
    out = {k: v.clone() if k.startswith("s") and torch.is_tensor(v) else v
           for k, v in st.items()}
    out["salive"][slot] = True
    out["spos"][slot] = st["pos"][best]
    out["svel"][slot] = st["vel"][best]
    out["sacc"][slot] = 0.0
    out["sspin"][slot] = 0.0
    out["smass"][slot] = sim["sink_create_mass"]
    out["sradius"][slot] = 2.0 * st["h"][best]
    return out


def merge_sinks(st, sim):
    """Real sinks closer than merge_factor x the smaller radius merge: each
    points at its lowest-index partner (or itself) and pointer jumping
    takes it to the end of that chain, its root, which takes the members'
    mass, centre of mass, momentum, largest radius and angular momentum
    (spins plus orbits about the new centre)."""
    spos, svel, smass = st["spos"], st["svel"], st["smass"]
    S = smass.shape[0]
    real = st["salive"] & (smass > 0.0)
    idx = torch.arange(S, device=spos.device)
    d2 = torch.sum((spos[:, None] - spos[None]) ** 2, dim=-1)
    thr = sim["sink_merge_factor"] * torch.minimum(
        st["sradius"][:, None], st["sradius"][None, :])
    link = (real[:, None] & real[None, :] & (d2 < thr * thr)
            & (idx[:, None] != idx[None, :]))
    target = torch.minimum(idx, torch.amin(
        torch.where(link, idx[None, :], S), dim=1))
    for _ in range(max(1, S.bit_length())):
        target = target[target]
    gone = real & (target != idx)
    claim = real[None, :] & (idx[:, None] == target[None, :])
    w = torch.where(claim, smass[None, :], 0.0)
    mt = torch.sum(w, dim=1)
    merged = mt > 0.0
    inv = torch.where(merged, 1.0 / torch.where(merged, mt, 1.0), 0.0)
    com = (w @ spos) * inv[:, None]
    cov = (w @ svel) * inv[:, None]
    orb = torch.linalg.cross(spos[None] - com[:, None],
                             svel[None] - cov[:, None], dim=-1)
    spin = (claim.to(smass.dtype) @ st["sspin"]
            + torch.sum(w[:, :, None] * orb, dim=1))
    rad = torch.amax(torch.where(claim, st["sradius"][None, :], 0.0), dim=1)
    upd = (real & ~gone & merged)
    out = dict(st)
    out["salive"] = st["salive"] & ~gone
    out["smass"] = torch.where(gone, 0.0, torch.where(upd, mt, smass))
    out["spos"] = torch.where(gone[:, None], PARK,
                              torch.where(upd[:, None], com, spos))
    out["svel"] = torch.where(gone[:, None], 0.0,
                              torch.where(upd[:, None], cov, svel))
    out["sspin"] = torch.where(gone[:, None], 0.0,
                               torch.where(upd[:, None], spin, st["sspin"]))
    out["sradius"] = torch.where(gone, 0.0,
                                 torch.where(upd, rad, st["sradius"]))
    return out


def cull(st, sim):
    b = sim["bounding_size"]
    gone = st["alive"] & ~torch.all(torch.abs(st["pos"]) <= b, dim=-1)
    out = _kill(st, gone)
    sgone = st["salive"] & ~torch.all(torch.abs(st["spos"]) <= b, dim=-1)
    out["salive"] = st["salive"] & ~sgone
    out["smass"] = torch.where(sgone, 0.0, st["smass"])
    out["spos"] = torch.where(sgone[:, None], PARK, st["spos"])
    out["svel"] = torch.where(sgone[:, None], 0.0, st["svel"])
    return out


# -------------------------------------------------------------- integrator

def kick(st, dt):
    out = dict(st)
    al = st["alive"]
    out["vel"] = torch.where(al[:, None], st["vel"] + 0.5 * dt * st["acc"],
                             st["vel"])
    if st.get("u_c") is None:
        out["u"] = torch.where(al, st["u"] + 0.5 * dt * st["du"], st["u"])
    else:
        y = 0.5 * dt * st["du"] - st["u_c"]
        t = st["u"] + y
        out["u_c"] = torch.where(al, (t - st["u"]) - y, st["u_c"])
        out["u"] = torch.where(al, t, st["u"])
    out["alpha"] = torch.where(al, st["alpha"] + 0.5 * dt * st["dalpha"],
                               st["alpha"])
    out["svel"] = torch.where(st["salive"][:, None],
                              st["svel"] + 0.5 * dt * st["sacc"], st["svel"])
    return out


def drift(st, dt):
    out = dict(st)
    out["pos"] = torch.where(st["alive"][:, None], st["pos"] + dt * st["vel"],
                             st["pos"])
    out["spos"] = torch.where(st["salive"][:, None],
                              st["spos"] + dt * st["svel"], st["spos"])
    return out


def next_dt(st, dt, sim):
    al = st["alive"]

    def ratio(a, b):
        ok = b > 0.0
        return torch.where(ok, a / torch.where(ok, b, 1.0), torch.inf)

    v2 = torch.sum(st["vel"] ** 2, dim=-1)
    a2 = torch.sum(st["acc"] ** 2, dim=-1)
    cand = torch.minimum(
        torch.minimum(torch.sqrt(ratio(v2, a2)),
                      ratio(st["u"], torch.abs(st["du"]))),
        torch.minimum(ratio(st["h"], torch.sqrt(v2)),
                      ratio(st["h"], 2.2 * st["cs"])))
    c = torch.amin(torch.where(al, cand, torch.inf)) * sim["timestep_scale"]
    grown = torch.where((c > 2.0 * dt) & (sim["dt_grow"] * dt < sim["dt_max"]),
                        sim["dt_grow"] * dt, dt)
    shrunk = torch.where((c < sim["dt_shrink"] * dt)
                         & (dt * sim["dt_shrink"] > sim["dt_min"]),
                         sim["dt_shrink"] * dt, grown)
    if not sim["dt_bound_candidate"]:
        return shrunk
    return torch.clamp(torch.minimum(shrunk, c), min=sim["dt_min"])


def newton_h(st, pi, pj, h_cap, sim):
    """The h-iteration: h_iter_max safeguarded Newton updates of
    h = eta (m / rho)^(1/3), the first on the force pass's rho and Omega,
    each later one on a density re-summed at the new h; a particle whose
    unclamped step is within convergence_criteria stops moving."""
    h, rho, om = st["h"], st["rho"], st["omega"]
    active = st["alive"]
    for it in range(sim["h_iter_max"]):
        if it > 0:
            rho, om = density(st, pi, pj, h, True)
        target = st["mass"] * (sim["eta"] / h) ** 3
        o = torch.where(om > 0.01, om, 1.0)
        h_raw = h * (1.0 + (target / rho - 1.0) / (3.0 * o))
        h_raw = torch.minimum(torch.maximum(h_raw, 0.5 * h), 2.0 * h)
        h_new = torch.minimum(torch.clamp(h_raw, min=0.01), h_cap)
        rel = torch.abs(h_raw - h) / h
        live = active & st["alive"]
        h = torch.where(live, h_new, h)
        active = live & (rel > sim["convergence_criteria"])
    out = dict(st)
    out.update(h=h, rho=rho, omega=om)
    return out


def force_eval(st, sim, phase, green):
    """Density, EOS, SPH forces, self-gravity and sink gravity at the
    current positions; returns (state, h_cap, pairs)."""
    var = sim["fixed_h"] is None
    origin, cell = sph_grid(st, sim)
    grid = CellGrid(st["pos"], st["alive"], origin, cell, reach=1)
    h = st["h"]
    h_cap = torch.clamp(cell / 2.0, max=sim["max_length"])
    if var:
        # every support the step can reach: 2 max(h_i, h_j, h_cap)
        reach = torch.maximum(h, h_cap)
        pi, pj = grid.pairs_within(
            lambda i, j: 4.0 * torch.maximum(reach[i], reach[j]) ** 2)
    else:
        pi, pj = grid.pairs_within(lambda i, j: 4.0 * h[i] * h[j])
    del grid
    out = dict(st)
    rho, om = density(out, pi, pj, h, var)
    pres, cs = eos(out["u"], rho, out["alive"], sim["gamma"])
    out.update(rho=rho, omega=om, pressure=pres, cs=cs)
    acc, du, araw = forces(out, pi, pj, sim, var)
    al = out["alive"]
    dalpha = alpha_rate(araw, rho, out["alpha"], cs, h, sim)
    acc = torch.where(al[:, None], acc, 0.0)
    du = torch.where(al, du, 0.0)
    dalpha = torch.where(al, dalpha, 0.0)
    if sim["gravity"] in PM_MODES:
        if phase == 0 or sim["pm_every"] <= 1:
            acc_long, r_s = pm_long(out, sim, green)
        else:
            acc_long, r_s = out["acc_ext"], out["pm_r_s"]
        if sim["pm_every"] > 1:
            out["acc_ext"], out["pm_r_s"] = acc_long, r_s
        acc = acc + acc_long + pm_short(out, r_s, rcut_rs(sim) * r_s)
    elif sim["gravity"] != "none":
        raise ValueError(f"the reference has no gravity {sim['gravity']!r}")
    acc_gs, acc_s = sink_gravity(out)
    out.update(acc=acc + acc_gs, du=du, dalpha=dalpha, sacc=acc_s)
    return out, h_cap, (pi, pj)


def step(st, sim, phase, green=None):
    """One KDK step with carried rates (`reuse_forces`)."""
    if not sim["reuse_forces"] or sim["dt_bins"] > 1:
        raise ValueError("the reference runs reuse_forces global steps")
    dt = st["dt"]
    st = drift(kick(st, dt), dt)
    st, h_cap, (pi, pj) = force_eval(st, sim, phase, green)
    st = kick(st, dt)
    st["t"] = st["t"] + dt
    st["dt"] = next_dt(st, dt, sim)
    if sim["fixed_h"] is None:
        st = newton_h(st, pi, pj, h_cap, sim)
        st = create_sink(st, sim)
    del pi, pj
    st = accrete(st)
    if sim["sink_merge_factor"] > 0.0:
        st = merge_sinks(st, sim)
    return cull(st, sim)


def run(st, sim, steps):
    """`steps` steps from `st`, the far field solved on the first and then
    every pm_every-th step, as one `run_steps` call of the program."""
    green = None
    if sim["gravity"] in PM_MODES:
        dtype = st["pos"].dtype
        green = _green_k(2 * sim["grav_grid"], float(sim["grav_split_rs"]),
                         torch.float32 if dtype == torch.bfloat16 else dtype,
                         st["pos"].device)
    every = max(sim["pm_every"], 1)
    for k in range(steps):
        st = step(st, sim, k % every, green)
    return st


__all__ = ["run", "step", "force_eval", "sph_grid", "gravity_grid",
           "pm_geometry", "rcut_rs", "PM_MODES"]
