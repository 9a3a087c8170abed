"""Candidates the SPH pair kernels test per live row, counted by the
program in every sort of the traced segments: its `sph_candidates`
counter (the window extents of every group times `window_group`) over its
`sph_rows` counter (the live rows), both summed over the sorts."""

from sphbench import spans

NAME = "sph_candidates_counted_per_row"
UNIT = "candidates/row"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "sort and windows (ops/sorted_grid.py)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["kepler_disc.n1m.sph", "collapse.n1m.early"]


def read(ctx):
    return spans.ratio(ctx, "sph_candidates", "sph_rows")
