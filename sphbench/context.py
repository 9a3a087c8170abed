"""What a per-layer metric reader (`metrics/<name>.py`) gets: `Context`.

It holds the end state of the window, the configuration, the program's
modules, the trace of the traced segments (None without a card or
without one), and helpers that the readers share: CUDA-event timing of a
call, the pairs a kernel's data need on the end state, and the rows and
window groups of a pair launch.
"""

from __future__ import annotations

import functools
import math

import torch

from . import reference
from .pairs import CellGrid

LANES = 128   # the program's padding granule of a sort


class Context:
    def __init__(self, *, prog, cfg, sim, state, trace, steps_traced):
        self.prog = prog            # namespace of the program's modules
        self.cfg = cfg              # the program's SimConfig
        self.sim = sim              # the configuration's fields, a dict
        self.state = state          # the program's state at the window's end
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
    @functools.cached_property
    def _ref_state(self):
        p = self.state.particles
        return {"pos": p.pos.double(), "h": p.h.double(), "alive": p.alive,
                "mass": p.mass.double()}

    def pairs(self, kind: str) -> float:
        """Pairs of distinct live particles the end state needs: `density`
        (r < 2 h_i inside the 27-cell stencil of the step's grid), `force`
        (r < 2 max(h_i, h_j) there), `gravity` (r < r_cut of the
        short-range split)."""
        if kind not in self._pairs:
            self._pairs[kind] = self._count_pairs(kind)
        return self._pairs[kind]

    def _count_pairs(self, kind: str) -> float:
        st = self._ref_state
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
