"""IC file generation.  Counterpart of `summersph_tpu/tools/make_ics.py`:
the port's model generators write reference-format `.txt` IC files, the
same bytes as the JAX package's for the same kind, size and seed."""

from __future__ import annotations

from ..io.txt import write_snapshot_txt
from ..models.disc import collapse_ic, disc_ic
from ..models.ring import ring_ic
from ..models.sod import sod_ic


GENERATORS = {
    # name -> (fn, default kwargs, snapshot columns)
    "disc": (disc_ic, dict(n=12000, r_max=100.0, m_disc=5.0, m_star=5.0,
                           rotation="keplerian"), 9),
    "rigid-sphere": (disc_ic, dict(n=12000, r_max=100.0, m_disc=5.0,
                                   m_star=0.0, rotation="rigid"), 9),
    "collapse": (collapse_ic, dict(n=20000, r_max=100.0, m_total=5.0), 9),
    "ring": (ring_ic, dict(n=4000, r0=50.0, width=5.0), 9),
    "sod": (sod_ic, dict(n=1000), 9),
}


def make_ics(kind: str, out_path: str, device="cuda", **overrides) -> str:
    """Generate ICs of the given kind on `device` (the card unless the
    caller asks for another) and write them as a reference-format file."""
    if kind not in GENERATORS:
        raise ValueError(f"unknown IC kind {kind!r}; choose from "
                         f"{sorted(GENERATORS)}")
    fn, defaults, columns = GENERATORS[kind]
    kw = dict(defaults)
    kw.update(overrides)
    state, _cfg = fn(device=device, **kw)
    write_snapshot_txt(out_path, state.particles, state.sinks,
                       columns=columns)
    return out_path


__all__ = ["make_ics", "GENERATORS"]
