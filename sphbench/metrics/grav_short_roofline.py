"""The short-range gravity kernel's share of its roofline: the least time
of its launches on the pairs within r_cut a step of the traced span
needs (`Context.pairs`: the mean of the counts on the span's two ends)
over its device time in the traced segments (kernel names starting with
`grav_short`)."""

NAME = "grav_short_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "short-range gravity (ops/pm_gravity.py grav_short)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early"]


def read(ctx):
    from sphbench import roofline

    got = ctx.kernel_seconds(("grav_short",))
    if not got or not got[0] or got[1] <= 0.0:
        return None
    launches, secs = got
    least = roofline.least_seconds("grav_short", ctx.pairs("gravity"),
                                   ctx.rows, ctx.groups)
    return 100.0 * launches * least / secs
