#!/usr/bin/env python3
"""How far two runs of a graded configuration drift apart when their
initial conditions differ by one float32 ulp: the spread that a run on
other hardware, with other rounding, can show against a reference ledger.

    python3 summersph_tpu_torch/utils/evidence_spread.py [NAME] [OUT]
        [--device cuda]

NAME is a config of `tools.evidence` (default disc100).  Its builder's
state runs twice through `tools.evidence.run` to end_time in segments of
64 steps: as built, into OUT/<NAME>_base, and with every live position
moved by one float32 ulp toward +inf (`torch.nextafter`), into
OUT/<NAME>_ulp (OUT defaults to `spread` in the working directory).
Printed: the largest relative deviation of the second ledger from the
first at matching t (`tools.config5.compare`) over each span of t between
0, 10, 40, 70 and the end, for E_kin, E_int, Lz and rho_max, as the
READMEs hold the runs against the JAX package's ledgers; and both runs'
end numbers (`evidence.readme_numbers`).  The repository root (this file's
grandparent's parent) is put first on sys.path.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="disc100")
    ap.add_argument("out", nargs="?", default="spread")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from summersph_tpu_torch.diagnostics import measure
    from summersph_tpu_torch.tools import config5, evidence

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("torch sees no CUDA card; pass --device cpu")
    ledgers, numbers = [], []
    for tag in ("base", "ulp"):
        state, cfg = evidence.BUILDERS[args.name](False, args.device)
        if tag == "ulp":
            p = state.particles
            moved = torch.nextafter(p.pos, torch.full_like(p.pos, np.inf))
            state = state.replace(particles=p.replace(
                pos=torch.where(p.alive[:, None], moved, p.pos)))
        d = measure(state)
        d0 = {k: float(d[k]) for k in ("n_gas", "mass_gas", "mass_sinks")}
        out = os.path.join(args.out, f"{args.name}_{tag}")
        _, code = evidence.run(args.name, state, cfg, out)
        if code:
            return code
        ledgers.append(config5.read_ledger(os.path.join(out, "ledger.csv")))
        numbers.append(evidence.readme_numbers(ledgers[-1], d0))
    base, ulp = ledgers
    t_end = float(min(base["t"][-1], ulp["t"][-1]))
    marks = [0.0, 10.0, 40.0, 70.0, t_end]
    spans = [(lo, hi) for lo, hi in zip(marks, marks[1:]) if lo < t_end]
    for (lo, hi), row in config5.compare(
            ulp, base, spans, ("E_kin", "E_int", "Lz", "rho_max")).items():
        print(f"[{args.name}] one ulp apart, {lo:g} <= t <= {hi:.3f} "
              f"({row.pop('rows')} rows), largest relative deviation: "
              + ", ".join(f"{c} {v:.3e}" for c, v in row.items()),
              flush=True)
    for tag, num in zip(("base", "ulp"), numbers):
        print(f"[{args.name} {tag}] t = {num['t_end']:.4f}: n_gas "
              f"{num['n_gas']}, accreted {num['accreted']:.6f}, mass drift "
              f"{num['mass_drift']:.3e}, L_z drift {num['lz_drift_pct']:.4f}"
              f"%, rho_max {num['rho_max']:.4e}, h_min {num['h_min']:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
