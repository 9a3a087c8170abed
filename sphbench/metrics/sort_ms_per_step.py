"""Device ms of the SPH sort a step: the union of the device operations
launched inside the program's `sort` spans (`sort_particles`: the cell
keys, the sort, the gather of the fields, the windows) in the traced
segments, over the steps."""

from sphbench import spans

NAME = "sort_ms_per_step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "sort and windows (ops/sorted_grid.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    return spans.per_step(ctx, lambda t: t.device_us(["sort"]) * 1e-3)
