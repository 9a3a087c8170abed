"""The fused force kernel's share of its roofline, with the `pack_force`
launch that forms its records before each: the least time of both over
their device time in the traced segments (kernel names starting with
`force_` or `pack_force`).  A fused launch needs the force pairs (r < 2h
inside the 27-cell stencil) at `ops_per_pair` FP32 operations and the
pairs within r_cut at `ops_per_grav_pair` more (`kernels/
force_fixed_h_grav.json`), each the mean of the counts on the traced
span's two ends; its least time is the larger of those operations over
the FP32 peak and its bytes over the memory rate."""

NAME = "force_grav_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "SPH pair kernels (csrc/sph_pairs.cu via ops/cuda_pairs.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc_sg.n1m.pm1"]
FORM = "force_fixed_h_grav"


def read(ctx):
    from sphbench import roofline

    cfg = ctx.cfg
    if not (cfg.grav_fuse_short and cfg.fixed_h is not None
            and cfg.gravity in ctx.prog.pm_gravity.PM_MODES):
        return None
    force = ctx.kernel_seconds(("force_",))
    pack = ctx.kernel_seconds(("pack_force",))
    if not force or not force[0] or force[1] + pack[1] <= 0.0:
        return None
    k = roofline.kernel(FORM)
    t_ops = (ctx.pairs(k["pairs"]) * k["ops_per_pair"]
             + ctx.pairs(k["grav_pairs"]) * k["ops_per_grav_pair"]
             ) / roofline.PEAK_FP32
    t_bytes = (k["bytes_per_row"] * ctx.rows
               + k["bytes_per_group"] * ctx.groups) / roofline.PEAK_BYTES
    least = (force[0] * max(t_ops, t_bytes)
             + pack[0] * roofline.least_seconds("pack_force", 0, ctx.rows,
                                                ctx.groups))
    return 100.0 * least / (force[1] + pack[1])
