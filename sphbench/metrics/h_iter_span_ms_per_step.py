"""Device ms of the h-iteration a step, read inside the step: the union
of the device operations launched inside the program's `h_iter` spans
(`update_smoothing`: the Newton updates and their density re-sums) in the
traced segments, over the steps (`h_iter_ms_per_step` times it by calling
it again on the end state)."""

from sphbench import spans

NAME = "h_iter_span_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "h-iteration (ops/smoothing.py update_smoothing)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early"]


def read(ctx):
    return spans.per_step(ctx, lambda t: t.device_us(["h_iter"]) * 1e-3
                          if "h_iter" in t.rows else None)
