"""The force kernels' share of their roofline, with the `pack_force`
launch that forms their records before each: the least time of both, on
the pairs a step of the traced span needs (the mean of the counts on its
two ends), over their device time in the traced segments (kernel names
starting with `force_` or `pack_force`)."""

NAME = "sph_force_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "SPH pair kernels (csrc/sph_pairs.cu via ops/cuda_pairs.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    from sphbench import roofline

    force = ctx.kernel_seconds(("force_",))
    pack = ctx.kernel_seconds(("pack_force",))
    if not force or not force[0] or force[1] + pack[1] <= 0.0:
        return None
    form = "force_var_h" if ctx.cfg.fixed_h is None else "force_fixed_h"
    least = (force[0] * roofline.least_seconds(form, ctx.pairs("force"),
                                               ctx.rows, ctx.groups)
             + pack[0] * roofline.least_seconds("pack_force", 0, ctx.rows,
                                                ctx.groups))
    return 100.0 * least / (force[1] + pack[1])
