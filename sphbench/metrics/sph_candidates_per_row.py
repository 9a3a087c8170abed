"""Candidates the SPH pair kernels test per live row in one pass over the
window's end state: the extents of every window group's 9 windows times
`window_group`, over the live rows (the arithmetic of the program's
`bench.pair_candidates`, on the step's own sort)."""

import torch

NAME = "sph_candidates_per_row"
UNIT = "candidates/row"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "sort and windows (ops/sorted_grid.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    sg = ctx.prog.sorted_grid
    p = ctx.state.particles
    _, grid = sg.sort_particles(p, ctx.cfg, h_pad=sg.sort_h_pad(ctx.cfg))
    live = int(p.n_alive)
    if not live:
        return None
    ext = int(torch.sum((grid.ends - grid.starts).to(torch.int64)))
    return ext * ctx.cfg.window_group / live
