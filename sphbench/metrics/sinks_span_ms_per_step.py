"""Device ms of the sink layers a step, read inside the step: the union
of the device operations launched inside the program's `sink_gravity`,
`create_sinks`, `accrete` and `merge_sinks` spans in the traced segments,
over the steps (`sinks_ms_per_step` times the same layers by calling them
again on the end state)."""

from sphbench import spans

NAME = "sinks_span_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "sinks (ops/gravity.py sink_gravity, ops/sinks.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]
LAYERS = ("sink_gravity", "create_sinks", "accrete", "merge_sinks")


def read(ctx):
    return spans.per_step(ctx, lambda t: t.device_us(LAYERS) * 1e-3)
