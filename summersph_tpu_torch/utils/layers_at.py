#!/usr/bin/env python3
"""Time a checkpointed state on one CUDA card: the step, its layers by
the program's spans, and the pair kernels of its config.

    python3 summersph_tpu_torch/utils/layers_at.py CHECKPOINT [STEPS]

CHECKPOINT is an npz written with its config (`tools.config5` writes one,
`<out>/checkpoint.npz`).  Printed, for the state as loaded: t, dt, the
live and sink counts, the h range and the SPH cell; the candidates per
row of the SPH sort and of the gravity sort (mean and maximum); the ms a
step of STEPS steps (default 16) of `run_steps` after as many warm-up
steps, the host clock closed by `torch.cuda.synchronize`; the span table
of 5 more steps under torch.profiler (`chip_smoke.span_table`: host and
device ms, launches and idle ms of each span name, the busy share); and
the config's pair kernels on the state (CUDA events, mean of 10 wrapper
calls).  The repository root (this file's grandparent's parent) is put
first on sys.path, for `chip_smoke.py` and the package beside it.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path, steps = argv[0], int(argv[1]) if len(argv) > 1 else 16
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from summersph_tpu_torch.integrate import run_steps
    from summersph_tpu_torch.io.checkpoint import load_npz_with_config
    from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
    from summersph_tpu_torch.ops.sorted_grid import sort_particles
    from summersph_tpu_torch.utils import build

    if not torch.cuda.is_available():
        sys.exit("layers_at: needs a CUDA card")
    build.build("sph_pairs")
    state, cfg = load_npz_with_config(path, device="cuda")
    p = state.particles
    label = f"t={float(state.t):.4f}"
    p2, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad)
    h = p.h[p.alive]
    ext = (grid.ends - grid.starts).sum(dim=1).float()
    sinks = state.sinks
    n_sinks = int((sinks.alive & (sinks.mass > 0)).sum())
    print(f"[{label}] dt {float(state.dt):.3e}, {int(p.n_alive)} live, "
          f"{n_sinks} sinks, h {float(h.min()):.4f} to "
          f"{float(h.max()):.4f}, SPH cell {float(grid.cell_size):.4f}; SPH "
          f"candidates per row: mean {float(ext.mean()):.1f} max "
          f"{int(ext.max())}", flush=True)
    r_s = pm_gravity.pm_geometry(p, cfg)[2]
    pos, m, hg, ggrid, _, gsplit = pm_gravity.gravity_sort(p, cfg, r_s)
    gext = (ggrid.ends - ggrid.starts).sum(dim=1).float()
    print(f"[{label}] gravity candidates per row: mean "
          f"{float(gext.mean()):.1f} max {int(gext.max())}", flush=True)
    warm = run_steps(state, cfg, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_steps(warm, cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = int(out.particles.n_alive) * steps / wall
    print(f"[{label}] {steps} steps after {steps} warm-up: "
          f"{wall / steps * 1e3:.3f} ms a step, t {float(warm.t):.6f} -> "
          f"{float(out.t):.6f}, {rate:.6e} particle-steps/s; counters "
          f"{out.stats_dict()}", flush=True)
    cs.span_table(out, cfg, 5, label)
    pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    calls = {"density": lambda: cuda_pairs.density_sums(p2, cfg, grid),
             "force": lambda: cuda_pairs.force_sums(pd, cfg, grid),
             "grav_short": lambda: cuda_pairs.grav_short_sums(
                 pos, m, hg, ggrid, cfg, gsplit)}
    print(f"[{label}] kernels on this state, ms: " + ", ".join(
        f"{name} {cs.cuda_ms(fn, 10):.4f}" for name, fn in calls.items()),
        flush=True)


if __name__ == "__main__":
    main()
