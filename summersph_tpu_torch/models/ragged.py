"""Small particle sets whose sorted windows are hard for a pair kernel:
the shapes that break a queue, a tile loop or an early cutoff.  Seeded
numpy, so a test can hand the same arrays to this package and to the JAX
one, and the smoke run can hand them to the card.

`ragged_case(name)` returns a dict of numpy arrays (pos, vel [n, 3]; mass,
u, h [n]) and the scalars `capacity` (> n: the rows past n are dead, so
the last window group ends in dead rows), `h0` (the fixed smoothing length
to use, and the largest variable one) and `r_cut` (a gravity cutoff no
wider than the sorted cell 2 h0):

- "clusters": clusters of 32, 31, 1, 33, 129, ... particles, each inside
  one sorted cell of side 2 h0 and three cells from the next, so that with
  `window_group` 32 the candidate ranges of the groups have lengths 0, 1,
  31, 32, 33 and 129 among others (`range_lengths` reports them).  One
  cluster is tight (every candidate of its rows lies inside the support),
  single particles have no pair at all, and two particles sit in opposite
  corners of one cell, more than 2 h0 apart: rows with candidates but no
  pair.  h varies by 30% for the variable-h passes.
- "clump": 3/4 of the particles in a Gaussian clump narrower than a cell,
  the rest spread over a few cells: one group's ranges hold hundreds of
  candidates, most of them inside the support.
- "h_gradient": a jittered lattice whose h grows threefold along x, so
  that many pairs reach only from their j side (r >= 2 h_i, r < 2 h_j).
"""

from __future__ import annotations

import numpy as np

CASES = ("clusters", "clump", "h_gradient")
CAPACITY = 512
# sizes of the clusters, in the order of the sort (x ascending)
CLUSTER_SIZES = (32, 31, 1, 33, 31, 129, 2, 1, 28, 32, 60)
TIGHT_CLUSTER = 9                  # index into CLUSTER_SIZES: all inside 2h;
                                   # it starts at row 288, a group's first
FAR_PAIR_CLUSTER = 6               # two particles > 2 h0 apart in one cell


def _fields(pos, h, rng, h0, r_cut):
    n = pos.shape[0]
    # a shear plus noise: approaching and receding pairs, so the viscosity
    # switch is on for some pairs and off for others
    vel = 0.3 * rng.standard_normal((n, 3))
    vel[:, 0] += 0.2 * pos[:, 1]
    return dict(pos=pos, vel=vel, mass=rng.uniform(0.5, 1.5, n) / n,
                u=rng.uniform(0.8, 1.2, n), h=h, capacity=CAPACITY,
                h0=h0, r_cut=r_cut)


def ragged_case(name: str, seed: int = 0):
    """The particle set `name` (one of CASES) as numpy arrays; see the
    module note."""
    rng = np.random.default_rng(seed)
    h0 = 1.0
    cell = 2.0 * h0
    if name == "clusters":
        parts = []
        for k, size in enumerate(CLUSTER_SIZES):
            corner = np.array([3.0 * k * cell, 0.0, 0.0])
            if k == TIGHT_CLUSTER:
                local = 0.5 * cell + 0.1 * h0 * rng.standard_normal((size, 3))
            elif k == FAR_PAIR_CLUSTER:
                local = np.array([[0.02, 0.02, 0.02], [0.98, 0.98, 0.98]])
                local = local * cell
            else:
                local = rng.uniform(0.02, 0.98, (size, 3)) * cell
            parts.append(corner + local)
        pos = np.concatenate(parts)
        pos[0] = 0.0                   # pins the sort's origin
        h = h0 * rng.uniform(0.7, 1.0, pos.shape[0])
        h[-1] = h0                     # the largest h sets the cell
        return _fields(pos, h, rng, h0, cell)
    if name == "clump":
        n = 480
        pos = rng.uniform(0.0, 4.0 * cell, (n, 3))
        pos[: 3 * n // 4] = 2.0 * cell + 0.25 * h0 * rng.standard_normal(
            (3 * n // 4, 3))
        h = h0 * rng.uniform(0.8, 1.0, n)
        h[-1] = h0
        return _fields(pos, h, rng, h0, cell)
    if name == "h_gradient":
        side = np.arange(8, dtype=np.float64)
        pos = np.stack(np.meshgrid(side, side, side[:7], indexing="ij"),
                       axis=-1).reshape(-1, 3)
        pos = pos + rng.uniform(-0.25, 0.25, pos.shape)
        h = 0.6 + 0.2 * np.clip(pos[:, 0], 0.0, None)
        h0 = float(h.max())
        return _fields(pos, h, rng, h0, 2.0 * h0)
    raise ValueError(f"unknown ragged case {name!r}; one of {CASES}")


def range_lengths(grid) -> set:
    """The lengths of all candidate ranges of a SortedGrid, as a set."""
    return set((grid.ends - grid.starts).flatten().tolist())


__all__ = ["CASES", "CAPACITY", "CLUSTER_SIZES", "ragged_case",
           "range_lengths"]
