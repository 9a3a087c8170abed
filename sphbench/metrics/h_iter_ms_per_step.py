"""ms of the h-iteration of one step: CUDA events around the benchmark's
calls of `update_smoothing` on the traced span's output state (the last
traced segment's), on the step's own sort with the force pass's density,
as `integrate._step` calls it."""

NAME = "h_iter_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "h-iteration (ops/smoothing.py update_smoothing)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early"]


def read(ctx):
    if ctx.cfg.fixed_h is not None:
        return None
    sg, cp = ctx.prog.sorted_grid, ctx.prog.cuda_pairs
    p2, grid = sg.sort_particles(ctx.state.particles, ctx.cfg,
                                 h_pad=sg.sort_h_pad(ctx.cfg))
    p2 = cp.density(p2, ctx.cfg, grid)
    return ctx.cuda_ms(lambda: ctx.prog.smoothing.update_smoothing(
        p2, ctx.cfg, grid=grid))
