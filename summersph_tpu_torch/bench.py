"""Benchmark: particle-steps/s on a Keplerian disc.  Counterpart of the
root `bench.py`, kept in the package because that script imports JAX.

    python -m summersph_tpu_torch bench [--n N] [--steps S] [--gravity G]
        [--device cuda]

Prints JSON lines with bench.py's keys, in its order:
    {"metric": ..., "value": N, "unit": "particle-steps/sec",
     "vs_baseline": value / 1e8, "platform": "gpu" | "cpu",
     "utilization": {...}, "sweep": {...}}
The headline line (N = 1,048,576, gravity 'none', one device) is printed
and flushed before any sweep work; the line is printed again after each
sweep cell, so the last line is the most complete.  A sweep cell that
raises is recorded as "failed: <error>" and makes the exit code 1.

Env knobs, as bench.py's: BENCH_N / BENCH_STEPS / BENCH_GRAVITY /
BENCH_PALLAS set the headline config (the flags override them);
BENCH_SWEEP=0 skips the sweep; BENCH_BUDGET_S (default 540) is the wall
budget past which sweep cells after the first are skipped; BENCH_PM_GRID,
BENCH_WG, BENCH_EXACT, BENCH_FUSE and BENCH_PM_EVERY shape the config
(`bench_config`).  bench.py's compile-cache checks, its backend probe and
the CPU fallback behind it are left out: the port has no compile cache,
and without a card the default device raises instead of falling quietly
to the CPU.
"""

from __future__ import annotations

import json
import os
import time
import traceback

import torch

BASELINE = 1e8   # bench.py's vs_baseline divisor (BASELINE.json north star)


def bench_config(n, gravity="none", grav_grid=None, pm_every=None,
                 use_pallas=True):
    """(cfg, h0) of bench.py's `run_config` (bench.py:69-119), field for
    field.  The window sizes are TPU knobs with no effect in the port
    (`config.py`); they are kept so the configs stay equal."""
    from .config import SimConfig

    # h so that the kernel support holds ~60 neighbours at this N
    h0 = 100.0 * (60.0 / n) ** (1.0 / 3.0) / 2.0
    grav_grid = grav_grid or int(os.environ.get("BENCH_PM_GRID", 256))
    if grav_grid >= 256:
        gw = 256 if n <= 524288 else 384
    else:
        gw = 384 if n <= 262144 else (512 if n <= 524288 else 768)
    wg_rows = int(os.environ.get("BENCH_WG",
                                 64 if gravity == "none" else 32))
    exact = os.environ.get("BENCH_EXACT", "0") == "1"
    # the fused short range is valid while r_cut <= the SPH cell, which
    # holds at grav_grid >= 256 in this geometry
    fuse = os.environ.get("BENCH_FUSE",
                          "1" if grav_grid >= 256 else "0") == "1"
    if pm_every is None:
        pm_every = int(os.environ.get("BENCH_PM_EVERY", 1))
    cfg = SimConfig(
        fixed_h=h0, gravity=gravity, neighbor_mode="sorted",
        use_pallas=use_pallas, sorted_block=128, window_group=wg_rows,
        pallas_window=256, pallas_fetch_window=768,
        grav_grid=grav_grid,
        grav_pallas_window=gw, grav_pallas_fetch=gw + 384,
        window_blocks=3, grav_window_blocks=8,
        pallas_exact_windows=exact,
        grav_fuse_short=fuse and gravity != "none",
        gamma=1.4, bounding_size=1500.0,
        dt_init=1e-4, dt_min=1e-5, dt_max=1e-3,
        pm_every=pm_every if gravity != "none" else 1,
    )
    return cfg, h0


def pair_candidates(state, cfg) -> float:
    """Candidates the pair kernels test in one pass over the state: the
    sum over window groups and planes of (end - start), each tested by
    the group's window_group rows.  The port's analogue of bench.py's
    pair-lane count, without the TPU's 128-lane alignment."""
    from .ops.sorted_grid import sort_h_pad, sort_particles

    _, grid = sort_particles(state.particles, cfg, h_pad=sort_h_pad(cfg))
    return float(torch.sum(grid.ends - grid.starts)) * cfg.window_group


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_disc(n, cfg, h0, device="cuda"):
    """bench.py's Keplerian disc around a central sink (seed 0)."""
    from .models.disc import disc_ic

    return disc_ic(n=n, r_max=100.0, m_star=5.0, h0=h0,
                   rotation="keplerian", cfg=cfg, seed=0, device=device)[0]


def timed_steps(state, cfg, steps):
    """`prime`, `run_steps(steps)` to warm up, then `run_steps(steps)`
    timed on the host clock, each closed by a synchronize on a card.
    Returns (end state, wall seconds of the timed steps)."""
    from .integrate import prime, run_steps

    device = state.particles.pos.device
    warm = run_steps(prime(state, cfg), cfg, steps)
    _sync(device)
    t0 = time.perf_counter()
    out = run_steps(warm, cfg, steps)
    _sync(device)
    return out, time.perf_counter() - t0


def run_config(n, steps, gravity, use_pallas=True, grav_grid=None,
               pm_every=None, device="cuda"):
    """(particle-steps/s, utilization) of one configuration on `device`
    (`timed_steps` on `bench_disc`).  utilization: the candidates tested
    per live row in a pass over the end state and their rate per second
    of a step."""
    cfg, h0 = bench_config(n, gravity, grav_grid, pm_every, use_pallas)
    out, wall = timed_steps(bench_disc(n, cfg, h0, device), cfg, steps)
    alive = int(out.particles.n_alive)
    cand = pair_candidates(out, cfg)
    util = {"pair_candidates_per_row": cand / max(alive, 1),
            "pair_candidate_rate_per_s": cand / (wall / steps)}
    return alive * steps / wall, util


def sweep_cells(n):
    """bench.py's sweep, (N, gravity, pm_every): the TreePM disc with the
    far field solved every 8th, 4th and every step, then the small disc
    without gravity."""
    return ((n, "pm", 8), (n, "pm", 4), (n, "pm", 1), (131072, "none", 1))


def cell_label(n, gravity, pm_every):
    """A sweep cell's key in the line, as bench.py writes it."""
    return (f"N={n},gravity={gravity}" if pm_every == 1
            else f"N={n},gravity={gravity},pm_every={pm_every}")


def emit(metric, value, sweep, platform, util=None):
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "particle-steps/sec",
        "vs_baseline": value / BASELINE,
        "platform": platform,
        "utilization": util or {},
        "sweep": sweep,
    }), flush=True)


def bench(n=None, steps=None, gravity=None, device="cuda") -> int:
    """The headline, then the sweep (bench.py:220-287).  Arguments given
    override the BENCH_* knobs.  Returns 1 if a sweep cell failed."""
    t_start = time.perf_counter()
    budget = float(os.environ.get("BENCH_BUDGET_S", 540.0))
    n = n or int(os.environ.get("BENCH_N", 1048576))
    steps = steps or int(os.environ.get("BENCH_STEPS", 20))
    gravity = gravity or os.environ.get("BENCH_GRAVITY", "none")
    use_pallas = os.environ.get("BENCH_PALLAS", "1") == "1"
    do_sweep = os.environ.get("BENCH_SWEEP", "1") == "1"
    kind = torch.device(device).type
    platform = "gpu" if kind == "cuda" else kind

    metric = (f"particle-steps/sec (Keplerian disc, N={n}, "
              f"gravity={gravity}, single chip)")
    value, util = run_config(n, steps, gravity, use_pallas, device=device)
    sweep = {}
    emit(metric, value, sweep, platform, util)  # before any sweep work

    failed = False
    if do_sweep:
        # the first cell, the self-gravitating disc, always runs
        for idx, (sn, sg, spe) in enumerate(sweep_cells(n)):
            if (sn, sg) == (n, gravity):
                continue
            label = cell_label(sn, sg, spe)
            if idx > 0 and time.perf_counter() - t_start > budget:
                sweep[label] = "skipped: wall budget"
            else:
                try:
                    sweep[label] = run_config(sn, steps, sg, use_pallas,
                                              pm_every=spe, device=device)[0]
                except Exception as e:  # recorded in the line, then rc 1
                    traceback.print_exc()
                    sweep[label] = f"failed: {e}"
                    failed = True
            emit(metric, value, sweep, platform, util)
    return 1 if failed else 0


def main(argv=None) -> int:
    """`python -m summersph_tpu_torch bench` with the flags in `argv`."""
    from .cli import main as cli_main

    return cli_main(["bench", *(argv or [])])


__all__ = ["bench_config", "bench_disc", "pair_candidates", "timed_steps",
           "run_config", "sweep_cells", "cell_label", "emit", "bench",
           "main"]
