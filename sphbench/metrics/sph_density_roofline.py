"""The density kernels' share of their roofline: the least time of their
launches (`roofline.least_seconds` on the pairs a step of the traced span
needs, the mean of the counts on its two ends) over their device time in
the traced segments, for the kernels whose names start with
`density_`."""

NAME = "sph_density_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "SPH pair kernels (csrc/sph_pairs.cu via ops/cuda_pairs.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    from sphbench import roofline

    got = ctx.kernel_seconds(("density_",))
    if not got or not got[0] or got[1] <= 0.0:
        return None
    launches, secs = got
    form = "density_var_h" if ctx.cfg.fixed_h is None else "density_fixed_h"
    least = roofline.least_seconds(form, ctx.pairs("density"), ctx.rows,
                                   ctx.groups)
    return 100.0 * launches * least / secs
