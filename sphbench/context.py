"""What a per-layer metric reader (`metrics/<name>.py`) gets: `Context`.

It holds the two ends of the traced span (the `trace_segments` segments
that ran under the profiler): `state_in`, the first traced segment's
input state, and `state`, the last traced segment's output; the
configuration, the program's modules, the trace of that span (None
without a card), and helpers that the readers share: CUDA-event timing
of a call, the pairs a kernel's data need over the span, and the rows
and window groups of a pair launch.

The pairs are counted on both ends and their mean is used: a trapezoid
over the span, exact where the count changes linearly from the one end
to the other.  So every reader reads the states the trace timed, and not
the window's end state, which lies further on the longer a run is, or
the faster the program.
"""

from __future__ import annotations

import math
import sys

import torch

from . import reference
from .pairs import CellGrid

LANES = 128   # the program's padding granule of a sort


class Context:
    def __init__(self, *, prog, cfg, sim, state_in, state, trace,
                 steps_traced):
        self.prog = prog            # namespace of the program's modules
        self.cfg = cfg              # the program's SimConfig
        self.sim = sim              # the configuration's fields, a dict
        self.state = state          # the traced span's output state
        self.state_in = state_in    # its input state
        self.trace = trace          # trace.Trace or None
        self.steps_traced = steps_traced
        self.on_card = state.particles.pos.is_cuda
        self._pairs = {}

    # ------------------------------------------------------------ timing
    def cuda_ms(self, fn, reps: int = 5):
        """Mean ms of `fn()` over `reps` calls after one unclocked call,
        by CUDA events; None off the card."""
        if not self.on_card:
            return None
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    # -------------------------------------------------------------- sizes
    @property
    def rows(self) -> int:
        n = self.state.particles.capacity
        g = max(self.cfg.sorted_block, LANES)
        return -(-n // g) * g

    @property
    def groups(self) -> int:
        return self.rows // self.cfg.window_group

    # -------------------------------------------------------------- pairs
    def pairs(self, kind: str) -> float:
        """Pairs of distinct live particles a step of the traced span
        needs, the mean of the counts on its two ends: `density` (r < 2
        h_i inside the 27-cell stencil of the step's grid), `force` (r < 2
        max(h_i, h_j) there), `gravity` (r < r_cut of the short-range
        split).  Prints one line on standard error: each end's simulated
        t and count, and the mean."""
        if kind not in self._pairs:
            ends = (self.state_in, self.state)
            counts = [self._count_pairs(s, kind) for s in ends]
            mean = math.fsum(counts) / 2
            print(f"pairs {kind}: t " + " -> ".join(
                f"{float(s.t):.9g}" for s in ends) + " yr, counted "
                + " -> ".join(f"{c:.0f}" for c in counts)
                + f", mean {mean:.1f}", file=sys.stderr, flush=True)
            self._pairs[kind] = mean
        return self._pairs[kind]

    def _count_pairs(self, state, kind: str) -> float:
        p = state.particles
        st = {"pos": p.pos.double(), "h": p.h.double(), "alive": p.alive,
              "mass": p.mass.double()}
        pos, h = st["pos"], st["h"]
        if kind == "gravity":
            r_cut = reference.rcut_rs(self.sim) * reference.pm_geometry(
                st, self.sim)[2]
            return float(reference.gravity_grid(st, r_cut).count_within(
                lambda i, j: r_cut * r_cut))
        origin, cell = reference.sph_grid(st, self.sim)
        grid = CellGrid(pos, st["alive"], origin, cell, reach=1)
        if kind == "density":
            return float(grid.count_within(lambda i, j: 4.0 * h[i] * h[i]))
        return float(grid.count_within(
            lambda i, j: 4.0 * torch.maximum(h[i], h[j]) ** 2))

    # -------------------------------------------------------------- trace
    def kernel_seconds(self, stems):
        """(launches, device seconds) of the traced kernels whose names
        start with one of `stems`; None without a trace."""
        if self.trace is None:
            return None
        ks = self.trace.kernels(stems)
        return len(ks), math.fsum(s for _, s in ks)


__all__ = ["Context"]
