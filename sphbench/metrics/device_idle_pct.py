"""The card's idle share over the traced segments: 100 (1 - the union of
the device operations' intervals / the traced wall time)."""

NAME = "device_idle_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (one H100)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
