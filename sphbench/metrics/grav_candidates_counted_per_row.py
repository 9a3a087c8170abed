"""Candidates the short-range gravity kernel tests per live row, counted
by the program in every gravity sort of the traced segments: its
`grav_candidates` counter (the window extents of every group of the
r_cut-wide sort times `window_group`) over its `grav_rows` counter."""

from sphbench import spans

NAME = "grav_candidates_counted_per_row"
UNIT = "candidates/row"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "short-range gravity (ops/pm_gravity.py grav_short)"
MOVES = "particle_steps_per_s"
WORKLOADS = ["collapse.n1m.early"]


def read(ctx):
    return spans.ratio(ctx, "grav_candidates", "grav_rows")
