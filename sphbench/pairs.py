"""Neighbour pairs of a particle set on a cubic cell grid, in plain torch.

The yardstick's own neighbour search, independent of the program's: the
plain reference (`reference.py`) sums its pair forces over these pairs,
and the roofline readers count the pairs a kernel's data need with them.

A grid has cells of side `cell` from `origin`, integer coordinates
floor((x - origin) / cell) clamped to [0, 1023] on every axis (the
program's sorted grid clamps the same way), and the cell key
(cx << 20) | (cy << 10) | cz.  Row i's candidates are the particles whose
cell lies in the (2 reach + 1)^3 cells around row i's cell.  With
reach 1 that is the SPH stencil of 27 cells: a pair beyond it is not
summed, whatever the kernel support says, as in the program.

`candidate_chunks` yields the candidates of blocks of rows as flat
(i, j) index vectors, sized so that a block holds about `budget`
candidates; the callers keep the pairs they need by distance.
"""

from __future__ import annotations

import torch

WINDOW = 1024
BITS = 10
SENTINEL = 1 << 40


def cell_coords(pos: torch.Tensor, origin: torch.Tensor, cell) -> torch.Tensor:
    """int64 [N, 3] cell coordinates, clamped to the 1024^3 window."""
    c = torch.floor((pos - origin) / cell)
    return torch.clamp(c, 0.0, WINDOW - 1).to(torch.int64)


def _key(c: torch.Tensor) -> torch.Tensor:
    return (c[..., 0] << (2 * BITS)) | (c[..., 1] << BITS) | c[..., 2]


class CellGrid:
    """The particles of `alive` binned by cell key, sorted once."""

    def __init__(self, pos, alive, origin, cell, reach: int = 1):
        self.pos, self.alive, self.reach = pos, alive, reach
        self.coords = cell_coords(pos, origin, cell)
        key = torch.where(alive, _key(self.coords),
                          torch.full_like(alive, SENTINEL, dtype=torch.int64))
        self.key_sorted, self.order = torch.sort(key)
        self._ranges()

    def _ranges(self):
        """lo, cnt [N, R]: for each row and each (dx, dy) column of its
        stencil, the sorted positions of the candidates in the z-run
        cz - reach .. cz + reach."""
        r = self.reach
        c = self.coords
        los, cnts = [], []
        zlo = torch.clamp(c[:, 2] - r, min=0)
        zhi = torch.clamp(c[:, 2] + r, max=WINDOW - 1)
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                cx, cy = c[:, 0] + dx, c[:, 1] + dy
                inside = ((cx >= 0) & (cx < WINDOW) & (cy >= 0)
                          & (cy < WINDOW) & self.alive)
                base = (cx << (2 * BITS)) | (cy << BITS)
                lo = torch.searchsorted(self.key_sorted, base | zlo)
                hi = torch.searchsorted(self.key_sorted, base | zhi,
                                        right=True)
                los.append(lo)
                cnts.append(torch.where(inside, hi - lo, 0))
        self.lo = torch.stack(los, dim=1)
        self.cnt = torch.stack(cnts, dim=1)

    def candidates_per_row(self) -> torch.Tensor:
        return torch.sum(self.cnt, dim=1)

    def candidate_chunks(self, budget: int = 1 << 26):
        """Yield (i, j), int64 flat vectors: every candidate of a block of
        rows (row i's own particle included)."""
        n = self.pos.shape[0]
        per_row = self.candidates_per_row()
        cum = torch.cumsum(per_row, dim=0)
        total = int(cum[-1]) if n else 0
        if total == 0:
            return
        # row boundaries where the running count crosses multiples of budget
        marks = torch.arange(budget, total + budget, budget,
                             device=cum.device)
        ends = torch.searchsorted(cum, marks, right=True).tolist()
        start = 0
        width = self.cnt.shape[1]
        for end in sorted(set(ends)):
            end = max(end, start + 1)
            end = min(end, n)
            if end <= start:
                continue
            rows = torch.arange(start, end, device=cum.device)
            cnt = self.cnt[start:end].reshape(-1)
            lo = self.lo[start:end].reshape(-1)
            m = int(torch.sum(cnt))
            if m:
                seg = torch.repeat_interleave(
                    torch.arange(cnt.shape[0], device=cnt.device), cnt,
                    output_size=m)
                first = torch.cumsum(cnt, dim=0) - cnt
                local = torch.arange(m, device=cnt.device) - first[seg]
                j = self.order[lo[seg] + local]
                i = rows[seg // width]
                yield i, j
            start = end
            if start >= n:
                break

    def _within(self, radius2_fn, budget):
        for i, j in self.candidate_chunks(budget):
            d = self.pos[i] - self.pos[j]
            r2 = torch.sum(d * d, dim=1)
            ok = (r2 > 0.0) & (r2 < radius2_fn(i, j))
            yield i[ok], j[ok]

    def pairs_within(self, radius2_fn, budget: int = 1 << 26):
        """(i, j) int64 of the distinct candidates with
        0 < r^2 < radius2_fn(i, j), concatenated over the blocks."""
        got = list(self._within(radius2_fn, budget))
        if not got:
            e = torch.zeros(0, dtype=torch.int64, device=self.pos.device)
            return e, e
        return (torch.cat([i for i, _ in got]),
                torch.cat([j for _, j in got]))

    def count_within(self, radius2_fn, budget: int = 1 << 26) -> int:
        """How many pairs `pairs_within` would return."""
        return sum(int(i.shape[0]) for i, _ in self._within(radius2_fn,
                                                             budget))


__all__ = ["CellGrid", "cell_coords", "WINDOW", "SENTINEL"]
