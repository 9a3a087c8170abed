#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (summersph_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero, and nothing is
caught:

1. print the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. build the CUDA pair kernels from summersph_tpu_torch/csrc with nvcc;
3. on the N = 131,072 Keplerian disc (bench.py's sweep geometry): hold each
   kernel against its plain PyTorch version after one sort + pair_eval,
   time both with CUDA events, and time the main path;
4. the main path at full size: the N = 1,048,576 disc with bench.py's
   headline config at gravity='none' -- prime, run_steps(20) to warm up,
   run_steps(20) timed -- with the kernels' launch counters reset just
   before, then checks (41 launches of each kernel, all health counters
   zero, check_health, particles lost only to accretion, finite
   diagnostics), a per-layer breakdown of one step, and each kernel against
   its plain version at these shapes;
5. print the kernels' JSON line and, last, {"ok": true, "device": ...}.

It exits non-zero, printing no result, when torch.cuda.is_available() is
false.  No JAX is imported.
"""

import json
import subprocess
import sys
import time

STEPS = 20
RHO_RTOL = 2e-5          # density vs plain version
FORCE_RTOL = 2e-4        # acc, du, dalpha raw sums vs plain version
FORCE_ATOL_REL = 1e-5    # atol = this x max|component|: another sum order
KERNELS = (
    # (name, wrapper, plain version, TPU kernel it replaces)
    ("density_fixed_h", "density_sums", "density_sums_plain",
     "summersph_tpu/ops/pallas_pairs.py:365"),
    ("force_fixed_h", "force_sums", "force_sums_plain",
     "summersph_tpu/ops/pallas_pairs.py:604"),
)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_config(n):
    """bench.py's config (bench.py:107-121) at gravity='none'."""
    from summersph_tpu_torch.config import SimConfig

    h0 = 100.0 * (60.0 / n) ** (1.0 / 3.0) / 2.0
    cfg = SimConfig(
        fixed_h=h0, gravity="none", neighbor_mode="sorted", use_pallas=True,
        sorted_block=128, window_group=64, pallas_window=256,
        pallas_fetch_window=768, window_blocks=3, gamma=1.4,
        bounding_size=1500.0, dt_init=1e-4, dt_min=1e-5, dt_max=1e-3)
    return cfg, h0


def disc(n, device):
    from summersph_tpu_torch.models.disc import disc_ic

    cfg, h0 = bench_config(n)
    state, _ = disc_ic(n=n, r_max=100.0, m_star=5.0, h0=h0,
                       rotation="keplerian", cfg=cfg, seed=0, device=device)
    return state, cfg


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


def compare_kernels(p_sorted, grid, cfg, label):
    """Each kernel against its plain version on the same sorted state;
    returns {name: (max_abs_err, kernel ms, plain ms)}."""
    import torch
    from summersph_tpu_torch.ops import cuda_pairs

    p_dens, _, _, _ = cuda_pairs.pair_eval(p_sorted, cfg, grid)
    inputs = {"density_fixed_h": p_sorted, "force_fixed_h": p_dens}
    out = {}
    for name, wrapper, plain, _ in KERNELS:
        p = inputs[name]
        k = getattr(cuda_pairs, wrapper)(p, cfg, grid)
        r = getattr(cuda_pairs, plain)(p, cfg, grid)
        torch.cuda.synchronize()
        k = (k,) if torch.is_tensor(k) else k
        r = (r,) if torch.is_tensor(r) else r
        err = 0.0
        for c, (a, b) in enumerate(zip(k, r)):
            require(bool(torch.isfinite(a).all()),
                    f"{name} output {c} not finite ({label})")
            if name == "density_fixed_h":
                tol = dict(rtol=RHO_RTOL, atol=0.0)
            else:
                tol = dict(rtol=FORCE_RTOL,
                           atol=FORCE_ATOL_REL * float(b.abs().max()))
            torch.testing.assert_close(a, b, **tol,
                                       msg=f"{name} output {c} ({label})")
            err = max(err, float((a - b).abs().max()))
            print(f"[{label}] {name} output {c}: max |kernel - plain| "
                  f"{float((a - b).abs().max()):.3e} within rtol "
                  f"{tol['rtol']:g} atol {tol['atol']:.3e}", flush=True)
        ms = cuda_ms(lambda: getattr(cuda_pairs, wrapper)(p, cfg, grid), 10)
        plain_ms = cuda_ms(lambda: getattr(cuda_pairs, plain)(p, cfg, grid),
                           2)
        out[name] = (err, ms, plain_ms)
        print(f"[{label}] {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms", flush=True)
    return out


def time_main_path(state, cfg):
    """prime, run_steps(STEPS) warm-up, run_steps(STEPS) timed.  Returns
    (primed state, warm-up state, final state, particle-steps/s, s/step)."""
    import torch
    from summersph_tpu_torch.integrate import prime, run_steps

    primed = prime(state, cfg)
    warm = run_steps(primed, cfg, STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(warm, cfg, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = int(out.particles.n_alive) * STEPS / wall
    return primed, warm, out, rate, wall / STEPS


def layer_breakdown(state, cfg):
    """CUDA-event milliseconds of each layer of one step (the body of
    integrate.step with reuse_forces), on `state`."""
    import torch
    from summersph_tpu_torch.integrate import (_count_nonfinite,
                                               _coverage_stats, drift, kick)
    from summersph_tpu_torch.ops import cuda_pairs, pairs
    from summersph_tpu_torch.ops.eos import eos_update
    from summersph_tpu_torch.ops.gravity import sink_gravity
    from summersph_tpu_torch.ops.sinks import accrete, cull_bounds
    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.ops.timestep import next_timestep

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    p, s, dt = state.particles, state.sinks, state.dt
    mark("start")
    p, s = drift(*kick(p, s, dt), dt)
    mark("kick+drift")
    p, grid = sort_particles(p, cfg)
    mark("sort")
    rho_raw = cuda_pairs.density_sums(p, cfg, grid)
    mark("density kernel")
    rho, _ = pairs.finalize_density(rho_raw, torch.zeros_like(rho_raw), p.h,
                                    p.alive, p.mass)
    p = eos_update(p.replace(rho=rho, omega=torch.ones_like(rho)), cfg)
    mark("finalize+EOS")
    ax, ay, az, du, araw = cuda_pairs.force_sums(p, cfg, grid)
    mark("force kernel")
    acc = torch.where(p.alive[:, None], torch.stack([ax, ay, az], -1), 0.0)
    dalpha = torch.where(p.alive, pairs.alpha_rate(araw, rho, p.alpha, p.cs,
                                                   p.h, cfg), 0.0)
    acc_gas_sink, acc_sink = sink_gravity(p, s)
    p = p.replace(acc=acc + acc_gas_sink, du=torch.where(p.alive, du, 0.0),
                  dalpha=dalpha)
    p, s = kick(p, s.replace(acc=acc_sink), dt)
    mark("alpha+sink gravity+kick")
    next_timestep(p, dt, cfg)
    mark("next_timestep")
    p, s = cull_bounds(*accrete(p, s), cfg)
    _coverage_stats(cfg, grid, torch.zeros((), dtype=torch.int32,
                                           device=p.pos.device),
                    _count_nonfinite(p))
    mark("accrete+cull+stats")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke run needs a CUDA card")

    from summersph_tpu_torch import diagnostics
    from summersph_tpu_torch.integrate import check_health
    from summersph_tpu_torch.ops import cuda_pairs
    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.utils import build

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

    # -- phase 2: build the kernels from csrc/
    t0 = time.perf_counter()
    lib = build.build("sph_pairs")
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in build.build_log("sph_pairs").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    dev = torch.device("cuda", 0)

    # -- phase 3: N = 131,072, kernels vs plain and the main path
    n_small = 131072
    state, cfg = disc(n_small, dev)
    p2, grid = sort_particles(state.particles, cfg)
    ext = (grid.ends - grid.starts).sum(dim=1)
    print(f"[N={n_small}] candidates per row: mean "
          f"{float(ext.float().mean()):.1f} max {int(ext.max())}",
          flush=True)
    compare_kernels(p2, grid, cfg, f"N={n_small}")
    _, _, out_s, rate_s, step_s = time_main_path(state, cfg)
    require(not any(out_s.stats.tolist()), f"stats {out_s.stats_dict()}")
    check_health(out_s, where=f"N={n_small}")
    print(f"[N={n_small}] main path: {rate_s:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed)", flush=True)

    # -- phase 4: N = 1,048,576, the main path at full size
    n = 1048576
    state, cfg = disc(n, dev)
    m_p = float(state.particles.mass[0])
    m_sink0 = float(state.sinks.mass[0])
    cuda_pairs.density_sums.launches = 0
    cuda_pairs.force_sums.launches = 0
    primed, warm, out, rate, step_s = time_main_path(state, cfg)
    launches = {"density_fixed_h": cuda_pairs.density_sums.launches,
                "force_fixed_h": cuda_pairs.force_sums.launches}
    print(f"[N={n}] main path: {rate:.6e} particle-steps/s "
          f"({step_s * 1e3:.3f} ms/step, {STEPS} steps timed) "
          f"launches {launches}", flush=True)
    for name, count in launches.items():
        require(count == 1 + 2 * STEPS,
                f"{name} launched {count} times, expected {1 + 2 * STEPS}")
    for st, what in ((warm, "warm-up"), (out, "timed")):
        require(not any(st.stats.tolist()),
                f"{what} stats not all zero: {st.stats_dict()}")
    check_health(out, where=f"N={n}")
    n_lost = n - int(out.particles.n_alive)
    accreted = (float(out.sinks.mass[0]) - m_sink0) / m_p
    require(abs(accreted - round(accreted)) < 1e-6
            and n_lost == round(accreted),
            f"{n_lost} particles lost but {accreted} accreted")
    d = diagnostics.measure(out)
    for key, val in d.items():
        require(bool(torch.isfinite(torch.as_tensor(val)).all()),
                f"measure()[{key!r}] not finite")
    print(f"[N={n}] {diagnostics.format_report(d)}; lost {n_lost} "
          f"particles, all accreted", flush=True)

    layers = layer_breakdown(out, cfg)
    total = sum(layers.values())
    print(f"[N={n}] one step by layer (CUDA events, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in layers.items())
        + f"; sum {total:.3f}", flush=True)
    p2, grid = sort_particles(out.particles, cfg)
    ext = (grid.ends - grid.starts).sum(dim=1)
    print(f"[N={n}] candidates per row: mean {float(ext.float().mean()):.1f}"
          f" max {int(ext.max())}", flush=True)
    at_main = compare_kernels(p2, grid, cfg, f"N={n}")

    # -- phase 5: results
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": cuda_pairs.SOURCE,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": at_main[name][0], "ms": at_main[name][1],
         "plain_ms": at_main[name][2]}
        for name, _, _, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
