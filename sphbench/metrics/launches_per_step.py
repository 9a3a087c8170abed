"""Device kernel launches the profiler saw in the traced segments, per
global step."""

NAME = "launches_per_step"
UNIT = "launches/step"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "driver and integrator (integrate.run_until, run_steps, _step)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    if ctx.trace is None or not ctx.steps_traced:
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.steps_traced if n else None
