"""Device ms of one particle-mesh solve, read inside the step: the union
of the device operations launched inside the program's `pm_long_range`
spans (a solve: deposit, FFTs, gradient, gather; a step that holds the far
field opens none) in the traced segments, over their count
(`pm_ms_per_solve` times it by calling it again on the end state)."""

from sphbench import spans

NAME = "pm_span_ms_per_solve"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "PM mesh (ops/pm_gravity.py pm_long_range)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early"]


def read(ctx):
    t = spans.of(ctx) if ctx.on_card else None
    row = None if t is None else t.rows.get("pm_long_range")
    if row is None or not row.count or not t.device_ops:
        return None
    return t.device_us(["pm_long_range"]) * 1e-3 / row.count
