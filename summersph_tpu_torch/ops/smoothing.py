"""Variable smoothing length: the grad-h Newton h-iteration.  Counterpart
of `summersph_tpu/ops/smoothing.py`, whose docstring gives the reference
lines and the reasons.

Each particle solves h = eta (m / rho(h))^(1/3) by the safeguarded Newton
update

    h <- clip(h (1 + (m (eta / h)^3 / rho - 1) / (3 Omega)), h / 2, 2 h)

(Omega <= 0.01 is taken as 1), clamped to [0.01, h_cap], for exactly
`cfg.h_iter_max` iterations in a Python loop.  A particle whose unclamped
step is within `cfg.convergence_criteria` stops moving; the loop never
ends early, which would need a device read per iteration and would change
the rho/Omega the step leaves behind.  In a step the iteration runs after
the forces on the step's own sort: the first update takes the force pass's
rho/Omega and every later one re-sums the density at the new h through
`cuda_pairs.density` (the `density_var_h` kernel on the card), so
`h_iter_max` iterations cost `h_iter_max - 1` density passes.  rho/Omega
are left at the previous h, as in the JAX package: the next step's force
pass recomputes them.  A block-timestep substep (blockstep.py) iterates
its closing rows only: `act_mask` starts the iteration from alive &
act_mask, and `active` = (worklist, count) gates the re-sums to the window
groups that hold such a row (`density_var_h_gated`); the caller takes h
alone from the result.  h_cap = min(max_length, cell / 2) keeps every
neighbour inside the sort's +-1-cell stencil, whose cells carry the
`cfg.sort_h_pad` headroom.

Returns (particles, n_unconverged): the live particles whose last
unclamped step still exceeded `cfg.convergence_criteria`, the
`h_unconverged` health counter.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import Particles
from .cuda_pairs import density
from .sorted_grid import SORTED_MODES, SortedGrid, sort_particles


def _newton(h, rho, omega, m, eta):
    """Safeguarded Newton update: Omega <= 0.01 drops the grad-h factor
    (the fixed-point step, always the right direction at a cloud rim), and
    one iteration at most halves or doubles h."""
    target = m * (eta / h) ** 3
    om = torch.where(omega > 0.01, omega, 1.0)
    h_new = h * (1.0 + (target / rho - 1.0) / (3.0 * om))
    return torch.minimum(torch.maximum(h_new, 0.5 * h), 2.0 * h)


def _newton_scan(p: Particles, cfg: SimConfig, dens, h_cap,
                 resum_first: bool, act_mask=None):
    """`cfg.h_iter_max` masked Newton iterations: re-sum (except the first
    unless `resum_first`), update, clamp to [0.01, h_cap], freeze the
    converged.  Convergence is judged on the unclamped step, so a particle
    held at the cap keeps tracking it.  Rows outside `act_mask` never
    move."""
    active = p.alive if act_mask is None else p.alive & act_mask
    n_open = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    for it in range(cfg.h_iter_max):
        if it > 0 or resum_first:
            p = dens(p)
        h_raw = _newton(p.h, p.rho, p.omega, p.mass, cfg.eta)
        h_new = torch.minimum(torch.clamp(h_raw, min=0.01), h_cap)
        rel = torch.abs(h_raw - p.h) / p.h
        live = active & p.alive
        p = p.replace(h=torch.where(live, h_new, p.h))
        active = live & (rel > cfg.convergence_criteria)
        n_open = torch.sum(active).to(torch.int32)
    return p, n_open


def _h_cap(cfg: SimConfig, grid: SortedGrid) -> torch.Tensor:
    """min(max_length, cell / 2), a 0-d tensor."""
    return torch.clamp(grid.cell_size / 2.0, max=cfg.max_length)


def _update_smoothing_shared(p: Particles, cfg: SimConfig,
                             grid: SortedGrid, active=None, act_mask=None):
    """The in-step path: `p` is in the sorted order of the step's `grid`
    with rho/Omega fresh from its force pass.  No sort; the first update
    reuses that density.  With `active` and `act_mask` the returned
    rho/Omega mean something on the active rows only."""
    vcfg = cfg.with_(fixed_h=None)
    return _newton_scan(
        p, cfg, lambda q: density(q, vcfg, grid, active, act_mask),
        _h_cap(cfg, grid), resum_first=False, act_mask=act_mask)


def _update_smoothing_sorted(p: Particles, cfg: SimConfig):
    """The standalone path (cold starts, tests): one sort with
    max(sort_h_pad, 1.25) headroom, the iteration with a first re-sum, and
    a closing re-sum so rho/Omega match the returned h.  The particles come
    back in sorted order, cut to their capacity."""
    cap0 = p.capacity
    vcfg = cfg.with_(fixed_h=None)
    p2, grid = sort_particles(p, cfg, h_pad=max(cfg.sort_h_pad, 1.25))

    def dens(q):
        return density(q, vcfg, grid)

    p_out, n_open = _newton_scan(p2, cfg, dens, _h_cap(cfg, grid),
                                 resum_first=True)
    p_out = dens(p_out)
    if p_out.capacity != cap0:
        p_out = p_out.map(lambda a: a[:cap0])
    return p_out, n_open


def update_smoothing(p: Particles, cfg: SimConfig, cols=None, grid=None,
                     axis_name=None, key_rows=None, active=None,
                     act_mask=None):
    """Newton-iterate h on `p`.  With the step's sorted `grid` (and `p` in
    its order with fresh rho/Omega) the shared path, on which `active` =
    (worklist, count) and `act_mask` restrict the iteration to a
    block-timestep substep's active rows; without a grid the standalone
    sorted path.  Returns (particles, n_unconverged int32).
    'grid' runs on the sorted engine, as in `integrate`.  The sharded
    (`cols`, `key_rows`, `axis_name`) and the dense engine are not ported
    and raise NotImplementedError."""
    if cols is not None or key_rows is not None or axis_name is not None:
        raise NotImplementedError(
            "update_smoothing: multi-device runs (cols/key_rows/axis_name) "
            "are not ported to summersph_tpu_torch yet")
    if cfg.neighbor_mode not in SORTED_MODES:
        raise NotImplementedError(
            f"update_smoothing: neighbor_mode={cfg.neighbor_mode!r} is not "
            f"ported (only 'sorted' and 'grid')")
    if grid is not None:
        return _update_smoothing_shared(p, cfg, grid, active, act_mask)
    if active is not None or act_mask is not None:
        raise ValueError("update_smoothing: active/act_mask need the "
                         "step's sorted grid")
    return _update_smoothing_sorted(p, cfg)


__all__ = ["update_smoothing"]
