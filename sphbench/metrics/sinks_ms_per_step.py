"""ms of the sink layers of one step: CUDA events around the benchmark's
calls, on the traced span's output state (the last traced segment's), of
`sink_gravity`, `accrete` and, where the configuration runs them,
`create_sinks` (variable h) and `merge_sinks` (sink_merge_factor > 0)."""

NAME = "sinks_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "sinks (ops/gravity.py sink_gravity, ops/sinks.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    grav, sinks, cfg = ctx.prog.gravity, ctx.prog.sinks, ctx.cfg
    p, s = ctx.state.particles, ctx.state.sinks

    def layer():
        grav.sink_gravity(p, s)
        if cfg.fixed_h is None:
            sinks.create_sinks(p, s, cfg)
        sinks.accrete(p, s)
        if cfg.sink_merge_factor > 0.0:
            sinks.merge_sinks(s, cfg)

    return ctx.cuda_ms(layer)
