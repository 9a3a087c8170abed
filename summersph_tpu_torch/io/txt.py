"""The reference `.txt` IC / snapshot format.  Counterpart of
`summersph_tpu/io/txt.py`, with the same rules:

* one header line (skipped on read);
* one whitespace-separated row per particle, x y z vx vy vz u m [alpha [h]];
* a row with u == 0 is a sink: its `m` column is the sink's mass and its
  trailing columns are ignored;
* a file with no sink row gets a zero-mass dummy sink at the origin, so
  the sink arrays are never empty;
* a snapshot is a valid IC file.

The alpha and h columns are read when present; a written snapshot holds
the live rows only, gas first, then sinks, each value as `%.17g`, so the
port and the JAX package write the same bytes for the same state.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..config import SimConfig
from ..state import Particles, Sinks


def read_ic_txt(
    path,
    cfg: Optional[SimConfig] = None,
    capacity: Optional[int] = None,
    sink_capacity: Optional[int] = None,
    device="cuda",
) -> Tuple[Particles, Sinks]:
    """Read a reference-format IC or snapshot file onto `device` (the card
    unless the caller asks for another)."""
    cfg = cfg or SimConfig()
    raw = np.loadtxt(path, skiprows=1, ndmin=2)
    if raw.shape[1] < 8:
        raise ValueError(f"{path}: expected >= 8 columns, got {raw.shape[1]}")

    is_sink = raw[:, 6] == 0.0
    gas, snk = raw[~is_sink], raw[is_sink]

    ncols = raw.shape[1]
    alpha = gas[:, 8] if ncols >= 9 else np.full(len(gas), 0.1)
    if ncols >= 10:
        h = gas[:, 9]
    else:
        h = np.full(len(gas), cfg.fixed_h if cfg.fixed_h is not None else 1.0)

    dtype = cfg.np_dtype()
    particles = Particles.create(
        pos=gas[:, 0:3], vel=gas[:, 3:6], mass=gas[:, 7], u=gas[:, 6],
        alpha=alpha, h=h, capacity=capacity, dtype=dtype, device=device)

    sink_cap = (sink_capacity if sink_capacity is not None
                else max(cfg.sink_capacity, max(len(snk), 1)))
    if len(snk) > 0:
        sinks = Sinks.create(
            pos=snk[:, 0:3], vel=snk[:, 3:6], mass=snk[:, 7],
            radius=np.full(len(snk), cfg.sink_radius),
            capacity=sink_cap, dtype=dtype, device=device)
    else:
        sinks = Sinks.create(
            pos=np.zeros((1, 3)), vel=np.zeros((1, 3)), mass=[0.0],
            radius=[0.0], capacity=sink_cap, dtype=dtype, device=device)
    return particles, sinks


_HEADER_8 = "x y z vx vy vz energy mass"
_HEADER_9 = _HEADER_8 + " alpha"
_HEADER_10 = _HEADER_9 + " smoothing"


def write_snapshot_txt(path, particles: Particles, sinks: Sinks,
                       columns: int = 9) -> None:
    """Write a reference-format snapshot: the live gas rows, then the live
    sink rows with u = 0.  `columns`: 9 = fixed h (x..m alpha), 10 =
    variable h (adds h), 8 = the minimal IC layout."""
    p = {k: getattr(particles, k).detach().cpu().numpy() for k in
         ("pos", "vel", "u", "mass", "alpha", "h", "alive")}
    s = {k: getattr(sinks, k).detach().cpu().numpy()
         for k in ("pos", "vel", "mass", "alive")}
    ga, sa = p["alive"], s["alive"]

    gcols = [p["pos"][ga], p["vel"][ga], p["u"][ga, None], p["mass"][ga, None]]
    if columns >= 9:
        gcols.append(p["alpha"][ga, None])
    if columns >= 10:
        gcols.append(p["h"][ga, None])
    gas = np.concatenate(gcols, axis=1)

    nsink = int(sa.sum())
    sink_rows = np.zeros((nsink, gas.shape[1]))
    sink_rows[:, 0:3] = s["pos"][sa]
    sink_rows[:, 3:6] = s["vel"][sa]
    sink_rows[:, 7] = s["mass"][sa]

    header = {8: _HEADER_8, 9: _HEADER_9, 10: _HEADER_10}[columns]
    np.savetxt(path, np.concatenate([gas, sink_rows], axis=0),
               header=header, comments="", fmt="%.17g")


def save_path(directory, number: int) -> str:
    """The reference's `saveN.txt` name."""
    return os.path.join(directory, f"save{number}.txt")


__all__ = ["read_ic_txt", "write_snapshot_txt", "save_path"]
