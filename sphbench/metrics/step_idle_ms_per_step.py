"""ms a step that the card idles while the host is inside a `step` span:
the holes in the traced segments' device union whose midpoint falls in a
`step` span or one of its descendants, over the steps.  Holes that the
profiler's own buffer requests name, and those between steps, are left
out."""

from sphbench import spans

NAME = "step_idle_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "driver and integrator (integrate.run_until, run_steps, _step)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    return spans.per_step(ctx, lambda t: t.rows["step"].idle_us * 1e-3)
