"""ms of one particle-mesh solve: CUDA events around the benchmark's own
calls of `pm_long_range` on the traced span's output state (the last
traced segment's), over the solves they made (`pm_long_range.solves`)."""

NAME = "pm_ms_per_solve"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "PM mesh (ops/pm_gravity.py pm_long_range)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early"]
REPS = 5


def read(ctx):
    pm = ctx.prog.pm_gravity
    if ctx.cfg.gravity not in pm.PM_MODES:
        return None
    p = ctx.state.particles
    before = pm.pm_long_range.solves
    ms = ctx.cuda_ms(lambda: pm.pm_long_range(p, ctx.cfg), REPS)
    solves = pm.pm_long_range.solves - before
    if ms is None or not solves:
        return None
    return ms * (REPS + 1) / solves
