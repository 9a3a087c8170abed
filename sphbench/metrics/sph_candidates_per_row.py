"""Candidates the SPH pair kernels test per live row in one pass, over
the traced span: the extents of every window group's 9 windows times
`window_group`, over the live rows (the arithmetic of the program's
`bench.pair_candidates`, on the step's own sort), counted on each of the
span's two ends and their mean taken, as `Context.pairs` does."""

import torch

NAME = "sph_candidates_per_row"
UNIT = "candidates/row"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "sort and windows (ops/sorted_grid.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def _per_row(ctx, state):
    sg = ctx.prog.sorted_grid
    p = state.particles
    _, grid = sg.sort_particles(p, ctx.cfg, h_pad=sg.sort_h_pad(ctx.cfg))
    live = int(p.n_alive)
    if not live:
        return None
    ext = int(torch.sum((grid.ends - grid.starts).to(torch.int64)))
    return ext * ctx.cfg.window_group / live


def read(ctx):
    ends = [_per_row(ctx, s) for s in (ctx.state_in, ctx.state)]
    if None in ends:
        return None
    return 0.5 * (ends[0] + ends[1])
