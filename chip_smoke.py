#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (summersph_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero, and nothing is
caught:

1. print the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. build the CUDA pair kernels from summersph_tpu_torch/csrc with nvcc;
3. on the N = 131,072 Keplerian disc (bench.py's sweep geometry): hold the
   density and force kernels against their plain PyTorch versions, time
   both with CUDA events, and time the gravity='none' main path;
4. the gravity kernels at N = 131,072: the fused force kernel at the
   grid-256 configuration, the short-range gravity kernel at the grid-128
   configuration and on a clustered clump (tests/test_grav_overflow.py's
   recipe), each against its plain version (the gravity sums against the
   plain version in float64, `hold_exact`); and the rms force error of
   both TreePM routes against the exact direct sum;
5. the gravity='none' main path at full size: the N = 1,048,576 disc with
   bench.py's headline config -- prime, run_steps(20) to warm up,
   run_steps(20) timed -- with every launch counter reset just before,
   then checks (41 launches of each SPH kernel, all health counters zero,
   check_health, particles lost only to accretion, finite diagnostics), a
   per-layer breakdown of one step, and each kernel against its plain
   version at these shapes;
6. the fused TreePM path at full size: N = 1,048,576, bench.py's first pm
   sweep cell (grav_grid 256, grav_fuse_short, pm_every 8): 41 fused
   force launches, 7 mesh solves, no short-range kernel launch, the same
   health checks, a layer breakdown of one solving step, the device busy
   share, and the fused kernel against its plain version;
7. the separate TreePM path at full size: grav_grid 128, pm_every 1: 41
   launches of the short-range kernel and 41 solves, the same checks, a
   layer breakdown, and the kernel against its plain version;
8. the variable-h kernels at N = 131,072 on config 5's collapse sphere
   (scripts/config5_run.py build(), h0 = 2.0) after one standalone
   h-iteration: density_var_h (rho_raw and Omega_raw) and force_var_h
   against their plain versions, force_var_h_grav at grid 256 with
   `hold_exact`;
9. the fused collapse path at N = 131,072 (config 5 with grid 256,
   grav_fuse_short, pm_every 8; 20 warm-up and 20 timed steps): 41
   force_var_h_grav and 121 density_var_h launches (1 + 3 per step: the
   force pass and the h-iteration's two re-sums), none of force_var_h,
   grav_short or the fixed-h kernels, and grav_window_overflow 0 on every
   step;
10. sink creation on the card at N = 131,072 on the separate route: after
   one step, `sink_create_density` is set below the densest particle's
   m (eta / h)^3; `create_sinks` seeds a sink with mass sink_create_mass
   and radius 2h at that particle, and 10 steps create at least one sink,
   with no full slots, no non-finite particle, gas lost equal to gas
   accreted and the total mass conserved to 1e-5;
11. the slice's path at full size: config 5 as built by
   scripts/config5_run.py at N = 1,048,576 (variable h, TreePM grid 128
   separate, pm_every 4, 128 sink slots, merging): prime, run_steps(20)
   warm-up, run_steps(20) timed; 121 density_var_h, 41 force_var_h, 41
   grav_short launches and 11 mesh solves, no fixed-h kernel; the window,
   non-finite and sink-slot counters 0 (sph_clamped and h_unconverged are
   printed: the JAX package counts them too); check_health, mass
   conservation, particle-steps/s, peak memory, a layer breakdown, the
   busy share, and both variable-h kernels against their plain versions
   at these shapes;
12. print the kernels' JSON line (with each kernel's bound: the larger of
   its input and output bytes over 3.35 TB/s and its FP32 operations on
   the pairs this run's data needs over 67 TFLOP/s) and, last,
   {"ok": true, "device": ...}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false.  No JAX is imported.
"""

import json
import subprocess
import sys
import time

STEPS = 20
RHO_RTOL = 2e-5          # density vs plain version
FORCE_RTOL = 2e-4        # acc, du, dalpha and gravity sums vs plain version
FORCE_ATOL_REL = 1e-5    # atol = this x max|component|: another sum order
PEAK_FP32 = 67e12        # H100 SXM FP32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
# FP32 operations per pair inside the support, counted from
# csrc/sph_pairs.cu (add, multiply, compare, rsqrt, exp and divide once,
# a fused multiply-add twice); the gravity sums in the fused kernel reuse
# the pair geometry (11 operations) of the force sums.  The variable-h
# density adds dw_shape and the dW/dh sum (11); the variable-h force adds
# the j-side skip, dW_j (7), dWbar, hbar, av_eps hbar^2 and the two-term
# pressure factor (16).
OPS_DENSITY, OPS_FORCE, OPS_GRAV, OPS_GEOMETRY = 20, 64, 55, 11
OPS_DENSITY_VAR, OPS_FORCE_VAR = 31, 80
KERNELS = {
    # name: (TPU kernel it replaces, bytes per row read and written)
    "density_fixed_h": ("summersph_tpu/ops/pallas_pairs.py:365", 24 + 4),
    "force_fixed_h": ("summersph_tpu/ops/pallas_pairs.py:604", 56 + 20),
    "force_fixed_h_grav": ("summersph_tpu/ops/pallas_pairs.py:657",
                           56 + 32),
    "grav_short": ("summersph_tpu/ops/pallas_pairs.py:880", 24 + 12),
    "density_var_h": ("summersph_tpu/ops/pallas_pairs.py:457", 24 + 8),
    "force_var_h": ("summersph_tpu/ops/pallas_pairs.py:699", 56 + 20),
    "force_var_h_grav": ("summersph_tpu/ops/pallas_pairs.py:699", 56 + 32),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def launch_counts():
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    return {"density_fixed_h": cuda_pairs.density_sums.launches,
            "force_fixed_h": cuda_pairs.force_sums.launches,
            "force_fixed_h_grav": cuda_pairs.force_sums.fused_launches,
            "grav_short": cuda_pairs.grav_short_sums.launches,
            "density_var_h": cuda_pairs.density_sums.var_launches,
            "force_var_h": cuda_pairs.force_sums.var_launches,
            "force_var_h_grav": cuda_pairs.force_sums.var_fused_launches,
            "mesh solves": pm_gravity.pm_long_range.solves}


def reset_counts():
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    cuda_pairs.density_sums.launches = 0
    cuda_pairs.density_sums.var_launches = 0
    cuda_pairs.force_sums.launches = 0
    cuda_pairs.force_sums.fused_launches = 0
    cuda_pairs.force_sums.var_launches = 0
    cuda_pairs.force_sums.var_fused_launches = 0
    cuda_pairs.grav_short_sums.launches = 0
    pm_gravity.pm_long_range.solves = 0


def bench_config(n, gravity="none", grav_grid=128, pm_every=1):
    """bench.py's config (bench.py:83-119): window_group 64 without
    gravity, 32 with it; grav_fuse_short at grav_grid >= 256."""
    from summersph_tpu_torch.config import SimConfig

    h0 = 100.0 * (60.0 / n) ** (1.0 / 3.0) / 2.0
    cfg = SimConfig(
        fixed_h=h0, gravity=gravity, neighbor_mode="sorted", use_pallas=True,
        sorted_block=128, window_group=64 if gravity == "none" else 32,
        pallas_window=256, pallas_fetch_window=768, grav_grid=grav_grid,
        window_blocks=3, grav_window_blocks=8,
        grav_fuse_short=gravity != "none" and grav_grid >= 256,
        gamma=1.4, bounding_size=1500.0, dt_init=1e-4, dt_min=1e-5,
        dt_max=1e-3, pm_every=pm_every if gravity != "none" else 1)
    return cfg, h0


def disc(n, device, **kw):
    from summersph_tpu_torch.models.disc import disc_ic

    cfg, h0 = bench_config(n, **kw)
    state, _ = disc_ic(n=n, r_max=100.0, m_star=5.0, h0=h0,
                       rotation="keplerian", cfg=cfg, seed=0, device=device)
    return state, cfg


def config5(n, device, **over):
    """scripts/config5_run.py's build() at N = n (h0 = (2^20 / n)^(1/3)),
    with `over` replacing config knobs; the TPU-only window knobs are
    accepted and have no effect.  Returns (state, cfg)."""
    from summersph_tpu_torch.config import SimConfig
    from summersph_tpu_torch.models.disc import disc_ic

    h0 = (1_048_576 / n) ** (1.0 / 3.0)
    cfg = SimConfig(
        fixed_h=None, eta=1.2, h_iter_max=3, convergence_criteria=1e-3,
        max_length=1.5 * h0, cell_h_quantile=0.9, gravity="pm",
        grav_grid=128, theta=0.5, neighbor_mode="sorted", use_pallas=True,
        sorted_block=128, window_group=32, pallas_window=256,
        pallas_fetch_window=2560, grav_pallas_window=1024,
        grav_pallas_fetch=8448, grav_overflow_items=65536, window_blocks=3,
        grav_window_blocks=8, gamma=1.1, bounding_size=1500.0,
        sink_capacity=128, sink_merge_factor=1.0, kahan_u=True, pm_every=4,
        dt_init=1e-4, dt_min=1e-7, dt_max=5e-3, end_time=12.0).with_(**over)
    state, _ = disc_ic(n=n, r_max=50.0, m_disc=50.0, m_star=0.0, u0=0.25,
                       rotation="rigidbody", v_circ=4.2, h0=h0, cfg=cfg,
                       seed=0, device=device)
    return state, cfg


def clustered(n, device):
    """tests/test_grav_overflow.py's clump recipe (seeded numpy): 3/4 of
    the particles in a Gaussian of 1.2 AU, the rest uniform in 100 AU."""
    import numpy as np
    from summersph_tpu_torch.state import Particles

    rng = np.random.default_rng(3)
    pos = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    pos[: 3 * n // 4] = rng.normal(0, 1.2, (3 * n // 4, 3))
    return Particles.create(pos=pos, vel=np.zeros((n, 3)),
                            mass=np.full(n, 1e-3), u=np.ones(n), h=0.5,
                            device=device)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` calls after one warm-up call,
    from CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def hold(name, kernel_out, plain_out, label, rtol=FORCE_RTOL,
         atol_rel=FORCE_ATOL_REL):
    """Each output of a kernel against its plain version; returns the
    largest |kernel - plain|."""
    import torch

    torch.cuda.synchronize()
    err = 0.0
    for c, (a, b) in enumerate(zip(kernel_out, plain_out)):
        require(bool(torch.isfinite(a).all()),
                f"{name} output {c} not finite ({label})")
        tol = dict(rtol=rtol, atol=atol_rel * float(b.abs().max()))
        torch.testing.assert_close(a, b, **tol,
                                   msg=f"{name} output {c} ({label})")
        e = float((a - b).abs().max())
        err = max(err, e)
        print(f"[{label}] {name} output {c}: max |kernel - plain| {e:.3e} "
              f"within rtol {tol['rtol']:g} atol {tol['atol']:.3e}",
              flush=True)
    return err


def hold_exact(name, kernel_out, plain_out, exact_out, label, first=0):
    """Sums whose terms nearly cancel (the gravity sums' f(r/h) - S(r);
    with variable h Omega_raw, a dW/dh sum of both signs, and the force
    sums of a rotating cloud, whose du and alpha_raw vanish with div v)
    lose digits in float32 in the kernel and its plain version alike.
    Each is held against the plain version on the same inputs in float64:
    within
    rtol 2e-4 and atol = 1e-5 x max|component| + twice the float32 plain
    version's own largest error.  Returns the largest |kernel - plain|."""
    import torch

    torch.cuda.synchronize()
    err = 0.0
    for c, (a, b, r) in enumerate(zip(kernel_out, plain_out, exact_out),
                                  start=first):
        require(bool(torch.isfinite(a).all()),
                f"{name} output {c} not finite ({label})")
        floor = float((b.double() - r).abs().max())
        tol = dict(rtol=FORCE_RTOL,
                   atol=FORCE_ATOL_REL * float(r.abs().max()) + 2 * floor)
        torch.testing.assert_close(a.double(), r, **tol,
                                   msg=f"{name} output {c} ({label})")
        e = float((a - b).abs().max())
        err = max(err, e)
        e64 = float((a.double() - r).abs().max())
        print(f"[{label}] {name} output {c}: max |kernel - plain| {e:.3e}; "
              f"against float64: kernel {e64:.3e}, plain {floor:.3e}, "
              f"within rtol {tol['rtol']:g} atol {tol['atol']:.3e}",
              flush=True)
    return err


def f64(p):
    """Particles with every float field in float64."""
    return p.map(lambda a: a.double() if a.is_floating_point() else a)


def compare(name, kernel, plain, label, plain_reps=2, exact=None, **tol):
    """Hold `kernel()` against `plain()`, then time both; returns
    (max_abs_err, kernel ms, plain ms).  With `exact` (the plain version
    in float64), the last outputs, as many as `exact()` gives, are sums
    that cancel and are held by `hold_exact`."""
    def flat(out):
        out = (out,) if not isinstance(out, tuple) else out
        return [t for o in out for t in ((o,) if not isinstance(o, tuple)
                                         else o)]

    k, p = flat(kernel()), flat(plain())
    q = flat(exact()) if exact is not None else []
    n_sph = len(k) - len(q)
    err = hold(name, k[:n_sph], p[:n_sph], label, **tol)
    if q:
        err = max(err, hold_exact(name, k[n_sph:], p[n_sph:], q, label,
                                  first=n_sph))
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, plain_reps)
    print(f"[{label}] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms", flush=True)
    return err, ms, plain_ms


def count_pairs(pos, grid, wg, radius2, h=None, both=False):
    """Pairs of distinct particles inside each row's windows and key mask
    with r^2 < radius2: the pairs whose arithmetic the sums need.  With
    per-particle `h`, radius2 is a factor: r^2 < radius2 h_i^2, or with
    `both` r^2 < radius2 max(h_i, h_j)^2 (the variable-h force pairs)."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs

    total = torch.zeros((), dtype=torch.int64, device=pos.device)
    for g0, g1, idx, valid, off in cuda_pairs._candidate_chunks(grid, wg):
        rows, mask, _, _, _, r2 = cuda_pairs._pair_geometry(
            pos, grid, wg, g0, g1, idx, valid, off)
        reach2 = radius2
        if h is not None:
            hh = h[rows].reshape(g1 - g0, wg, 1)
            if both:
                hh = torch.maximum(hh, h[idx][:, None, :])
            reach2 = radius2 * hh * hh
        total += torch.sum(mask & (r2 > 0.0) & (r2 < reach2))
    return int(total)


def bound(name, n_rows, groups, ops):
    """(bound_ms, bound_by): the larger of the bytes the kernel must move
    over the card's memory rate and its FP32 operations over the FP32
    peak."""
    t_bytes = (KERNELS[name][1] * n_rows + 72 * groups) / PEAK_BYTES
    t_ops = ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def sph_pair_counts(p, grid, cfg):
    """(density pairs, force pairs) the sums need: inside 2h with fixed
    h; inside 2 h_i and inside 2 max(h_i, h_j) with variable h."""
    wg = cfg.window_group
    if cfg.fixed_h is not None:
        n = count_pairs(p.pos, grid, wg, 4.0 * cfg.fixed_h ** 2)
        return n, n
    return (count_pairs(p.pos, grid, wg, 4.0, h=p.h),
            count_pairs(p.pos, grid, wg, 4.0, h=p.h, both=True))


def sph_kernels(p_sorted, grid, cfg, label):
    """The density and force kernels (fixed-h or variable-h by cfg) against
    their plain versions on one sorted state; returns {name: (err, ms,
    plain_ms, bound_ms, by)}.  With variable h, Omega_raw and the force
    sums are held in float64 (`hold_exact`)."""
    from summersph_tpu_torch.ops import cuda_pairs

    var = cfg.fixed_h is None
    dname, fname = (("density_var_h", "force_var_h") if var
                    else ("density_fixed_h", "force_fixed_h"))
    p_dens = cuda_pairs.pair_eval(p_sorted, cfg, grid)[0]
    if var:
        p64, pd64 = f64(p_sorted), f64(p_dens)
        dens = compare(
            dname, lambda: cuda_pairs.density_sums(p_sorted, cfg, grid),
            lambda: cuda_pairs.density_sums_plain(p_sorted, cfg, grid),
            label, rtol=RHO_RTOL, atol_rel=0.0,
            exact=lambda: cuda_pairs.density_sums_plain(p64, cfg, grid)[1])
        force = compare(
            fname, lambda: cuda_pairs.force_sums(p_dens, cfg, grid),
            lambda: cuda_pairs.force_sums_plain(p_dens, cfg, grid), label,
            exact=lambda: cuda_pairs.force_sums_plain(pd64, cfg, grid))
    else:
        dens = compare(
            dname, lambda: cuda_pairs.density_sums(p_sorted, cfg, grid)[0],
            lambda: cuda_pairs.density_sums_plain(p_sorted, cfg, grid)[0],
            label, rtol=RHO_RTOL, atol_rel=0.0)
        force = compare(
            fname, lambda: cuda_pairs.force_sums(p_dens, cfg, grid),
            lambda: cuda_pairs.force_sums_plain(p_dens, cfg, grid), label)
    out = {dname: dens, fname: force}
    n_dens, n_force = sph_pair_counts(p_sorted, grid, cfg)
    rows, groups = p_sorted.capacity, grid.starts.shape[0]
    if var:
        print(f"[{label}] pairs inside 2h_i: {n_dens} ({n_dens / rows:.1f} "
              f"per row); inside 2 max(h_i, h_j): {n_force} "
              f"({n_force / rows:.1f} per row)", flush=True)
    else:
        print(f"[{label}] pairs inside 2h: {n_dens} ({n_dens / rows:.1f} "
              f"per row)", flush=True)
    out[dname] += bound(dname, rows, groups,
                        n_dens * (OPS_DENSITY_VAR if var else OPS_DENSITY))
    out[fname] += bound(fname, rows, groups,
                        n_force * (OPS_FORCE_VAR if var else OPS_FORCE))
    return out


def fused_kernel(p_sorted, grid, cfg, label):
    """The fused force kernel (fixed-h or variable-h by cfg) against its
    plain version at the step's split; returns (err, ms, plain_ms,
    bound_ms, by)."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    var = cfg.fixed_h is None
    name = "force_var_h_grav" if var else "force_fixed_h_grav"
    p_dens = cuda_pairs.pair_eval(p_sorted, cfg, grid)[0]
    r_s = pm_gravity.pm_geometry(p_sorted, cfg)[2]
    split = (r_s, cfg.effective_rcut_rs() * r_s)
    require(float(split[1]) <= float(grid.cell_size),
            f"r_cut {float(split[1])} > SPH cell {float(grid.cell_size)}")
    p64, split64 = f64(p_dens), tuple(v.double() for v in split)
    # the gravity sums in float64; with variable h all eight
    first = 0 if var else 5
    res = compare(
        name, lambda: cuda_pairs.force_sums(p_dens, cfg, grid, split),
        lambda: cuda_pairs.force_sums_plain(p_dens, cfg, grid, split), label,
        exact=lambda: cuda_pairs.force_sums_plain(p64, cfg, grid,
                                                  split64)[first:])
    n_sph = sph_pair_counts(p_sorted, grid, cfg)[1]
    n_grav = count_pairs(p_sorted.pos, grid, cfg.window_group,
                         split[1] ** 2)
    print(f"[{label}] r_s {float(r_s):.4f} r_cut {float(split[1]):.4f} "
          f"SPH cell {float(grid.cell_size):.4f}; pairs inside "
          f"{'2 max(h_i, h_j)' if var else '2h'} {n_sph}, inside r_cut "
          f"{n_grav}", flush=True)
    return res + bound(name, p_sorted.capacity, grid.starts.shape[0],
                       n_sph * (OPS_FORCE_VAR if var else OPS_FORCE)
                       + n_grav * (OPS_GRAV - OPS_GEOMETRY))


def grav_kernel(p, cfg, label, plain_reps=2):
    """The short-range gravity kernel against its plain version on the
    gravity sort of `p` at its mesh split; returns (err, ms, plain_ms,
    bound_ms, by)."""
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

    r_s = pm_gravity.pm_geometry(p, cfg)[2]
    pos, m, h, ggrid, _, split = pm_gravity.gravity_sort(p, cfg, r_s)
    ext = (ggrid.ends - ggrid.starts).sum(dim=1)
    print(f"[{label}] gravity windows: r_cut {float(split[1]):.4f}, "
          f"candidates per row mean {float(ext.float().mean()):.1f} max "
          f"{int(ext.max())}", flush=True)
    exact = (pos.double(), m.double(), h.double(), ggrid, cfg,
             tuple(v.double() for v in split))
    res = compare(
        "grav_short",
        lambda: cuda_pairs.grav_short_sums(pos, m, h, ggrid, cfg, split),
        lambda: cuda_pairs.grav_short_sums_plain(pos, m, h, ggrid, cfg,
                                                 split),
        label, plain_reps=plain_reps,
        exact=lambda: cuda_pairs.grav_short_sums_plain(*exact))
    n_grav = count_pairs(pos, ggrid, cfg.window_group, split[1] ** 2)
    print(f"[{label}] pairs inside r_cut: {n_grav} "
          f"({n_grav / p.capacity:.1f} per row)", flush=True)
    return res + bound("grav_short", pos.shape[0], ggrid.starts.shape[0],
                       n_grav * OPS_GRAV)


def pm_vs_direct(state, label):
    """rms and median relative error of the two TreePM routes (separate at
    grid 128, fused at grid 256) against the exact direct sum, printed:
    the mesh delivers the unsoftened force beyond r_cut, where the direct
    sum still softens up to 2h, so the size of the error depends on the
    mesh and is no pass mark."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs, gravity, pm_gravity
    from summersph_tpu_torch.ops.sorted_grid import sort_particles

    n = state.particles.capacity
    cfg128, _ = bench_config(n, gravity="pm", grav_grid=128)
    cfg256, _ = bench_config(n, gravity="pm", grav_grid=256)
    p2, grid = sort_particles(state.particles, cfg256)
    direct = gravity.gas_gravity_direct(p2, cfg256)
    sep = pm_gravity.gas_gravity_pm(p2, cfg128)[0]
    r_s = pm_gravity.pm_geometry(p2, cfg256)[2]
    out = cuda_pairs.pair_eval(p2, cfg256, grid,
                               (r_s, cfg256.effective_rcut_rs() * r_s))
    fused = pm_gravity.pm_long_range(p2, cfg256)[0] + out[4]
    mag = torch.linalg.norm(direct, dim=1)
    live = p2.alive
    for route, acc in (("separate, grid 128", sep), ("fused, grid 256",
                                                     fused)):
        rel = (torch.linalg.norm(acc - direct, dim=1)
               / torch.clamp(mag, min=1e-12))[live]
        rms = float(torch.sqrt(torch.mean(rel ** 2)))
        require(bool(torch.isfinite(acc).all()), f"{route} not finite")
        print(f"[{label}] gas_gravity_pm ({route}) vs gas_gravity_direct: "
              f"rms relative error {rms:.4e}, median "
              f"{float(torch.median(rel)):.4e}", flush=True)


def time_main_path(state, cfg):
    """prime, run_steps(STEPS) warm-up, run_steps(STEPS) timed.  Returns
    (warm-up state, final state, particle-steps/s, s/step)."""
    import torch
    from summersph_tpu_torch.integrate import prime, run_steps

    warm = run_steps(prime(state, cfg), cfg, STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(warm, cfg, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = int(out.particles.n_alive) * STEPS / wall
    return warm, out, rate, wall / STEPS


def check_run(state, warm, out, label):
    """Health counters zero, check_health, particles lost only to
    accretion, finite diagnostics."""
    import torch
    from summersph_tpu_torch import diagnostics
    from summersph_tpu_torch.integrate import check_health

    n = state.particles.capacity
    m_p = float(state.particles.mass[0])
    m_sink0 = float(state.sinks.mass[0])
    for st, what in ((warm, "warm-up"), (out, "timed")):
        require(not any(st.stats.tolist()),
                f"{label} {what} stats not all zero: {st.stats_dict()}")
    check_health(out, where=label)
    n_lost = n - int(out.particles.n_alive)
    accreted = (float(out.sinks.mass[0]) - m_sink0) / m_p
    require(abs(accreted - round(accreted)) < 1e-6
            and n_lost == round(accreted),
            f"{label}: {n_lost} particles lost but {accreted} accreted")
    d = diagnostics.measure(out)
    for key, val in d.items():
        require(bool(torch.isfinite(torch.as_tensor(val)).all()),
                f"{label}: measure()[{key!r}] not finite")
    print(f"[{label}] {diagnostics.format_report(d)}; lost {n_lost} "
          f"particles, all accreted", flush=True)


def check_collapse(state, warm, out, label):
    """The variable-h paths' checks: the window, non-finite and sink-slot
    counters zero on every step (sph_clamped and h_unconverged printed),
    check_health, gas lost equal to gas accreted, the total mass conserved
    to 1e-5, finite diagnostics."""
    import torch
    from summersph_tpu_torch import diagnostics
    from summersph_tpu_torch.integrate import check_health

    for st, what in ((warm, "warm-up"), (out, "timed")):
        d = st.stats_dict()
        bad = {k: d[k] for k in ("sph_window_overflow",
                                 "grav_window_overflow", "nonfinite",
                                 "sink_slots_full") if d[k]}
        require(not bad, f"{label} {what} counters tripped: {d}")
        print(f"[{label}] {what} counters (maximum over the steps): "
              f"sph_clamped {d['sph_clamped']}, h_unconverged "
              f"{d['h_unconverged']}; the window, non-finite and sink-slot "
              f"counters 0", flush=True)
    check_health(out, where=label)
    n_lost = int(state.particles.n_alive) - int(out.particles.n_alive)
    m_p = float(state.particles.mass[0])
    gained = float(out.sinks.mass.double().sum()
                   - state.sinks.mass.double().sum())
    total0 = float(state.particles.mass.double().sum()
                   + state.sinks.mass.double().sum())
    total1 = float(out.particles.mass.double().sum()
                   + out.sinks.mass.double().sum())
    require(abs(gained - n_lost * m_p) <= 1e-5 * max(gained, m_p),
            f"{label}: {n_lost} particles lost, sinks gained {gained}")
    require(abs(total1 - total0) <= 1e-5 * total0,
            f"{label}: total mass {total0} -> {total1}")
    d = diagnostics.measure(out)
    for key, val in d.items():
        require(bool(torch.isfinite(torch.as_tensor(val)).all()),
                f"{label}: measure()[{key!r}] not finite")
    print(f"[{label}] {diagnostics.format_report(d)}; lost {n_lost} "
          f"particles, all accreted; total mass {total0:.7g} -> "
          f"{total1:.7g}", flush=True)


def layer_breakdown(state, cfg):
    """CUDA-event milliseconds of each layer of one step (the body of
    integrate.step with reuse_forces, solving the mesh when gravity is
    on; with variable h also the h-iteration and sink creation and
    merging), on `state`."""
    import torch
    from summersph_tpu_torch.integrate import (_count_nonfinite,
                                               _coverage_stats, drift, kick)
    from summersph_tpu_torch.ops import cuda_pairs, pairs, pm_gravity
    from summersph_tpu_torch.ops.eos import eos_update
    from summersph_tpu_torch.ops.gravity import sink_gravity
    from summersph_tpu_torch.ops.sinks import (accrete, create_sinks,
                                               cull_bounds, merge_sinks)
    from summersph_tpu_torch.ops.smoothing import update_smoothing
    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.ops.timestep import next_timestep

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    grav = cfg.gravity in pm_gravity.PM_MODES
    fuse = grav and cfg.grav_fuse_short
    var = cfg.fixed_h is None
    p, s, dt = state.particles, state.sinks, state.dt
    mark("start")
    p, s = drift(*kick(p, s, dt), dt)
    mark("rest")
    p, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad if var else 1.0)
    mark("sort")
    split = None
    if grav:
        origin, cell, r_s = pm_gravity.pm_geometry(p, cfg)
        split = (r_s, cfg.effective_rcut_rs() * r_s)
        mark("rest")
    rho_raw, omega_raw = cuda_pairs.density_sums(p, cfg, grid)
    mark("density kernel")
    rho, omega = pairs.finalize_density(rho_raw, omega_raw, p.h, p.alive,
                                        p.mass)
    if not var:
        omega = torch.ones_like(omega)
    p = eos_update(p.replace(rho=rho, omega=omega), cfg)
    mark("finalize+EOS")
    out = cuda_pairs.force_sums(p, cfg, grid, split if fuse else None)
    mark("fused force kernel" if fuse else "force kernel")
    ax, ay, az, du, araw = out[:5]
    acc = torch.where(p.alive[:, None], torch.stack([ax, ay, az], -1), 0.0)
    dalpha = torch.where(p.alive, pairs.alpha_rate(araw, rho, p.alpha, p.cs,
                                                   p.h, cfg), 0.0)
    mark("rest")
    if grav:
        n = cfg.grav_grid
        m = torch.where(p.alive, p.mass, 0.0)
        rho_pad = torch.zeros((2 * n,) * 3, dtype=p.pos.dtype,
                              device=p.pos.device)
        rho_pad[:n, :n, :n] = pm_gravity._cic_deposit(p.pos, m, origin,
                                                      cell, n) / cell ** 3
        mark("CIC deposit")
        phi_k = (torch.fft.rfftn(rho_pad)
                 * pm_gravity.grav_tables(cfg, p.pos.dtype, p.pos.device)
                 * (cell * cell))
        grads = pm_gravity._fd4_gradient(
            torch.fft.irfftn(phi_k, s=(2 * n,) * 3), cell)
        force = torch.stack([g[:n, :n, :n] for g in grads], dim=-1)
        mark("FFT + gradient")
        acc_long = pm_gravity._cic_gather(force, p.pos, origin, cell, n)
        mark("CIC gather")
        if fuse:
            acc = acc + acc_long + torch.stack(out[5], -1)
        else:
            pos_s, m_s, h_s, ggrid, perm, gsplit = pm_gravity.gravity_sort(
                p, cfg, r_s)
            mark("gravity sort")
            g = cuda_pairs.grav_short_sums(pos_s, m_s, h_s, ggrid, cfg,
                                           gsplit)
            mark("short-range kernel")
            acc_s = torch.empty_like(p.pos)
            acc_s[perm[:p.capacity]] = torch.stack(g, -1)[:p.capacity]
            acc = acc + acc_long + acc_s
        mark("rest")
    acc_gas_sink, acc_sink = sink_gravity(p, s)
    mark("sink gravity")
    p = p.replace(acc=acc + acc_gas_sink, du=torch.where(p.alive, du, 0.0),
                  dalpha=dalpha)
    p, s = kick(p, s.replace(acc=acc_sink), dt)
    next_timestep(p, dt, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    n_open = full = zero
    if var:
        mark("rest")
        p, n_open = update_smoothing(p, cfg, grid=grid)
        mark("h-iteration (re-sums + Newton)")
        s, full = create_sinks(p, s, cfg)
        p, s = accrete(p, s)
        if cfg.sink_merge_factor > 0.0:
            s, _ = merge_sinks(s, cfg)
        mark("create/accrete/merge")
        p, s = cull_bounds(p, s, cfg)
    else:
        p, s = cull_bounds(*accrete(p, s), cfg)
    _coverage_stats(cfg, grid, zero, n_open, _count_nonfinite(p), full)
    mark("rest")
    torch.cuda.synchronize()
    layers = {}
    for i in range(1, len(marks)):
        name = marks[i][0]
        layers[name] = (layers.get(name, 0.0)
                        + marks[i - 1][1].elapsed_time(marks[i][1]))
    return layers


def print_layers(layers, label):
    total = sum(layers.values())
    print(f"[{label}] one step by layer (CUDA events, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in layers.items()) + f"; sum {total:.3f}",
        flush=True)


def device_busy(state, cfg, steps, label):
    """Device kernel time over wall time for `steps` steps under
    torch.profiler, and the five kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from summersph_tpu_torch.integrate import run_steps

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(state, cfg, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    if dev_us <= 0:
        print(f"[{label}] device busy share: not measured (the profiler "
              f"saw no device time)", flush=True)
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    print(f"[{label}] profiler, {steps} steps: device {dev_us / 1e3:.3f} ms "
          f"of {wall * 1e3:.3f} ms wall, busy share {dev_us / 1e6 / wall:.3f}"
          f"; top kernels (ms per step): " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f}"
              for e in top), flush=True)


def run_path(state, cfg, expect, label, check):
    """One main path: reset the counts, prime + warm-up + timed steps, read
    the counts and check them against `expect`; then `check` (health),
    the peak memory, a layer breakdown, the busy share.  Returns
    (launches, final state, cfg)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()
    warm, out, rate, step_s = time_main_path(state, cfg)
    launches = launch_counts()
    print(f"[{label}] main path: {rate:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed) launches "
          f"{launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s with prime and warm-up",
          flush=True)
    for name, count in expect.items():
        require(launches[name] == count,
                f"{label}: {name} counted {launches[name]}, expected {count}")
    check(state, warm, out, label)
    print_layers(layer_breakdown(out, cfg), label)
    device_busy(out, cfg, 5, label)
    return launches, out, cfg


def sink_creation(n, dev, label, steps=10):
    """Config 5 at N = n on the separate route: one step, then the creation
    threshold below the densest particle's m (eta / h)^3.  `create_sinks`
    must seed a sink at that particle (mass sink_create_mass, radius 2h,
    its position); then `steps` one-step segments must create at least one
    sink, with no full slots or non-finite particle, gas lost equal to gas
    accreted and the total mass conserved to 1e-5."""
    import torch
    from summersph_tpu_torch.integrate import check_health, prime, run_steps
    from summersph_tpu_torch.ops.sinks import create_sinks

    state, cfg = config5(n, dev)
    st = run_steps(prime(state, cfg), cfg, 1)
    p = st.particles
    code = torch.where(p.alive, p.mass * (cfg.eta / p.h) ** 3, 0.0)
    best = int(torch.argmax(code))
    cfg = cfg.with_(sink_create_density=0.95 * float(code[best]))
    s2, full = create_sinks(p, st.sinks, cfg)
    new = torch.nonzero(s2.alive & ~st.sinks.alive)[:, 0].tolist()
    require(len(new) == 1 and int(full) == 0,
            f"{label}: create_sinks made {new}, slots_full {int(full)}")
    k = new[0]
    require(float(s2.mass[k]) == float(torch.tensor(cfg.sink_create_mass))
            and float(s2.radius[k]) == 2.0 * float(p.h[best])
            and torch.equal(s2.pos[k], p.pos[best]),
            f"{label}: seed sink mass {float(s2.mass[k])} radius "
            f"{float(s2.radius[k])} at {s2.pos[k].tolist()}, particle "
            f"{best} h {float(p.h[best])} at {p.pos[best].tolist()}")
    print(f"[{label}] threshold {cfg.sink_create_density:.6e} (0.95 x the "
          f"densest m (eta/h)^3): create_sinks seeded slot {k} with mass "
          f"{float(s2.mass[k]):.3g} and radius {float(s2.radius[k]):.4f} = "
          f"2h at particle {best}", flush=True)
    out, created, d = st, 0, {}
    for _ in range(steps):
        nxt = run_steps(out, cfg, 1)
        created += int((nxt.sinks.alive & ~out.sinks.alive).sum())
        out = nxt
        d = {k2: max(d.get(k2, 0), v) for k2, v in out.stats_dict().items()}
    require(created >= 1, f"{label}: no sink created in {steps} steps")
    require(d["sink_slots_full"] == 0 and d["nonfinite"] == 0,
            f"{label}: counters {d}")
    check_collapse(st, st, out, label)
    check_health(out, where=label)
    print(f"[{label}] {created} sinks created in {steps} steps, "
          f"{int(out.sinks.n_alive)} alive; counters {d}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke run needs a CUDA card")

    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.utils import build

    t_start = time.perf_counter()
    phase_t = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        print(f"== phase {name}: {now - phase_t[0]:.1f} s "
              f"(total {now - t_start:.1f} s)", flush=True)
        phase_t[0] = now

    # -- phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: build the kernels from csrc/ (one source, one nvcc)
    lib = build.build("sph_pairs")
    print(f"built {lib.name}", flush=True)
    for line in build.build_log("sph_pairs").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    dev = torch.device("cuda", 0)
    phase_done("card + build")

    # -- phase 3: N = 131,072, SPH kernels vs plain and the main path
    n_small = 131072
    state, cfg = disc(n_small, dev)
    p2, grid = sort_particles(state.particles, cfg)
    label = f"N={n_small}"
    sph_kernels(p2, grid, cfg, label)
    _, out_s, rate_s, step_s = time_main_path(state, cfg)
    require(not any(out_s.stats.tolist()), f"stats {out_s.stats_dict()}")
    print(f"[{label}] main path: {rate_s:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed)", flush=True)
    phase_done("3 (N=131072, gravity none)")

    # -- phase 4: N = 131,072, the gravity kernels vs plain
    st256, cfg256 = disc(n_small, dev, gravity="pm", grav_grid=256,
                         pm_every=8)
    p2, grid = sort_particles(st256.particles, cfg256)
    fused_kernel(p2, grid, cfg256, f"{label} grid 256")
    st128, cfg128 = disc(n_small, dev, gravity="pm", grav_grid=128)
    grav_kernel(st128.particles, cfg128, f"{label} grid 128")
    grav_kernel(clustered(n_small, dev), cfg128, f"{label} clustered clump",
                plain_reps=1)
    pm_vs_direct(st128, label)
    phase_done("4 (N=131072, gravity kernels)")

    # -- phase 5: N = 1,048,576, gravity='none' at full size
    n = 1048576
    label = f"N={n}"
    state, cfg = disc(n, dev)
    reset_counts()
    warm, out, rate, step_s = time_main_path(state, cfg)
    none_launches = launch_counts()
    print(f"[{label}] main path: {rate:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed) "
          f"launches {none_launches}", flush=True)
    for name in ("density_fixed_h", "force_fixed_h"):
        require(none_launches[name] == 1 + 2 * STEPS,
                f"{name} launched {none_launches[name]} times, expected "
                f"{1 + 2 * STEPS}")
    check_run(state, warm, out, label)
    print_layers(layer_breakdown(out, cfg), label)
    p2, grid = sort_particles(out.particles, cfg)
    ext = (grid.ends - grid.starts).sum(dim=1)
    print(f"[{label}] candidates per row: mean {float(ext.float().mean()):.1f}"
          f" max {int(ext.max())}", flush=True)
    results = sph_kernels(p2, grid, cfg, label)
    phase_done("5 (N=1048576, gravity none)")

    # -- phase 6: the fused TreePM path at full size (pm_every 8)
    solves = 1 + 2 * len(range(0, STEPS, 8))
    fused_launches, out, cfg = run_path(
        *disc(n, dev, gravity="pm", grav_grid=256, pm_every=8),
        {"force_fixed_h_grav": 1 + 2 * STEPS, "density_fixed_h":
         1 + 2 * STEPS, "force_fixed_h": 0, "grav_short": 0,
         "mesh solves": solves}, f"{label} pm fused grid 256", check_run)
    p2, grid = sort_particles(out.particles, cfg)
    results["force_fixed_h_grav"] = fused_kernel(
        p2, grid, cfg, f"{label} pm fused grid 256")
    phase_done("6 (N=1048576, fused TreePM)")

    # -- phase 7: the separate TreePM path at full size (pm_every 1)
    sep_launches, out, cfg = run_path(
        *disc(n, dev, gravity="pm", grav_grid=128, pm_every=1),
        {"grav_short": 1 + 2 * STEPS, "mesh solves": 1 + 2 * STEPS,
         "force_fixed_h": 1 + 2 * STEPS, "force_fixed_h_grav": 0},
        f"{label} pm separate grid 128", check_run)
    results["grav_short"] = grav_kernel(out.particles, cfg,
                                        f"{label} pm separate grid 128")
    phase_done("7 (N=1048576, separate TreePM)")

    # -- phase 8: the variable-h kernels at N = 131,072 on config 5's ICs
    from summersph_tpu_torch.ops.smoothing import update_smoothing
    label = f"N={n_small} collapse"
    state, cfg = config5(n_small, dev)
    p, _ = update_smoothing(state.particles, cfg)
    p2, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad)
    h = p2.h[p2.alive]
    print(f"[{label}] after one h-iteration: h {float(h.min()):.4f} to "
          f"{float(h.max()):.4f}, SPH cell {float(grid.cell_size):.4f}",
          flush=True)
    sph_kernels(p2, grid, cfg, label)
    fused_kernel(p2, grid, cfg.with_(grav_grid=256, grav_fuse_short=True,
                                     pm_every=8), f"{label} grid 256")
    phase_done("8 (N=131072, variable-h kernels)")

    # -- phase 9: the fused collapse path at N = 131,072
    label = f"N={n_small} collapse fused grid 256"
    var_fused_launches, out, cfg = run_path(
        *config5(n_small, dev, grav_grid=256, grav_fuse_short=True,
                 pm_every=8),
        {"force_var_h_grav": 1 + 2 * STEPS,
         "density_var_h": 1 + 3 * 2 * STEPS, "force_var_h": 0,
         "grav_short": 0, "density_fixed_h": 0, "force_fixed_h": 0,
         "force_fixed_h_grav": 0, "mesh solves": solves},
        label, check_collapse)
    p2, grid = sort_particles(out.particles, cfg, h_pad=cfg.sort_h_pad)
    results["force_var_h_grav"] = fused_kernel(p2, grid, cfg, label)
    phase_done("9 (N=131072, fused collapse)")

    # -- phase 10: sink creation on the card
    sink_creation(n_small, dev, f"N={n_small} sink creation")
    phase_done("10 (N=131072, sink creation)")

    # -- phase 11: the slice's path, config 5 at N = 1,048,576
    label = f"N={n} config 5"
    c5_launches, out, cfg = run_path(
        *config5(n, dev),
        {"density_var_h": 1 + 3 * 2 * STEPS, "force_var_h": 1 + 2 * STEPS,
         "grav_short": 1 + 2 * STEPS,
         "mesh solves": 1 + 2 * len(range(0, STEPS, 4)),  # pm_every 4
         "density_fixed_h": 0, "force_fixed_h": 0, "force_fixed_h_grav": 0,
         "force_var_h_grav": 0},
        label, check_collapse)
    p2, grid = sort_particles(out.particles, cfg, h_pad=cfg.sort_h_pad)
    ext = (grid.ends - grid.starts).sum(dim=1)
    print(f"[{label}] candidates per row: mean {float(ext.float().mean()):.1f}"
          f" max {int(ext.max())}; SPH cell {float(grid.cell_size):.4f}",
          flush=True)
    results.update(sph_kernels(p2, grid, cfg, label))
    phase_done("11 (N=1048576, config 5)")

    # -- phase 12: results
    launches = {"density_fixed_h": none_launches["density_fixed_h"],
                "force_fixed_h": none_launches["force_fixed_h"],
                "force_fixed_h_grav": fused_launches["force_fixed_h_grav"],
                "grav_short": sep_launches["grav_short"],
                "density_var_h": c5_launches["density_var_h"],
                "force_var_h": c5_launches["force_var_h"],
                "force_var_h_grav": var_fused_launches["force_var_h_grav"]}
    from summersph_tpu_torch.ops import cuda_pairs
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": cuda_pairs.SOURCE,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2], "bound_ms": results[name][3],
         "bound_by": results[name][4], "library_ms": None}
        for name, (replaces, _) in KERNELS.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
