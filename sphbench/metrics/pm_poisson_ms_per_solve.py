"""Device ms of one particle-mesh solve's Poisson part, read inside the
step: the union of the device operations launched inside the program's
`pm_poisson` spans (the zero pad, the forward transform, the Green's
product and the inverse) in the traced segments, over their count.  A
program without the span reads None."""

from sphbench import spans

NAME = "pm_poisson_ms_per_solve"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "PM mesh (ops/pm_gravity.py pm_long_range)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early", "kepler_disc_sg.n1m.pm1"]
SPAN = "pm_poisson"


def read(ctx):
    t = spans.of(ctx) if ctx.on_card else None
    row = None if t is None else t.rows.get(SPAN)
    if row is None or not row.count or not t.device_ops:
        return None
    return t.device_us([SPAN]) * 1e-3 / row.count
