"""The whole step's share of the card's FP32 peak: the FP32 operations
the step's pair passes need over the traced span (the density launches,
the force launches and, with TreePM, the short-range gravity, each as
`kernels/<name>.json` counts them on the mean of the pair counts on the
span's two ends, times the launches per step the trace saw), per step,
over the traced wall time per step and the peak.  It bounds every kernel's roofline share from above: a kernel taken
off the path leaves its share silent, and this number still moves."""

NAME = "step_mfu"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "the whole step (integrate._step)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    from sphbench import roofline

    tr = ctx.trace
    if tr is None or not ctx.steps_traced or tr.window_s <= 0.0:
        return None
    var = ctx.cfg.fixed_h is None
    parts = [("density_", "density_var_h" if var else "density_fixed_h",
              "density"),
             ("force_", "force_var_h" if var else "force_fixed_h", "force"),
             ("grav_short", "grav_short", "gravity")]
    ops = 0.0
    for stem, form, kind in parts:
        launches = len(tr.kernels((stem,)))
        if launches:
            ops += launches * roofline.flops(form, ctx.pairs(kind))
    if ops <= 0.0:
        return None
    return 100.0 * ops / tr.window_s / roofline.PEAK_FP32
