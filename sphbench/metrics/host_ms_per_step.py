"""Host wall ms of one step, read from the program's own `step` spans in
the traced segments: their summed wall time over their count.  The host
sets the disc's pace; where the card sets it, a reading near the device
step means some span waits for the card, and its host self time in the
`span` lines names which one."""

from sphbench import spans

NAME = "host_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "driver and integrator (integrate.run_until, run_steps, _step)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    return spans.per_step(ctx, lambda t: t.rows["step"].host_us * 1e-3)
