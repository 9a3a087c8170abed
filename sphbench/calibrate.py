#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the chip.

    python3 sphbench/calibrate.py --workload NAME --seeds S1 S2 ...
        [--segments K] [--control N] [--fault NAME] [--out FILE]

For each seed, in one process: the run's set-up, a window of K segments
(default 12), the seeded sample of its segments, and for each sampled
segment the numbers of `compare.numbers` for the program against the
float64 reference (the lower readings) and, for the first N seeds
(default 3), for the control, the reference computed in bfloat16, against
the same float64 reference (the upper readings).  With `--fault` the
program runs with that fault of `faults.py` planted in it, and its
readings are the fault's.  With variable h each program line also gives
`h_rel`: the RMS over the particles of |h_out - h_ref| / h_ref and of the
segment's own change |h_ref - h_in| / h_ref, the largest over the
sampled segments.  One JSON line per seed and kind goes to standard
output and to FILE when given.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sphbench import compare, faults  # noqa: E402
from sphbench.run import Cell  # noqa: E402


def h_rel(d_in, d_out, d_ref) -> dict:
    """RMS relative error and change of h over the particles alive in all
    three states."""
    by = {k: {f: compare._by_pid(st, f) for f in ("h", "alive")}
          for k, st in (("in", d_in), ("out", d_out), ("ref", d_ref))}
    both = by["in"]["alive"] & by["out"]["alive"] & by["ref"]["alive"]
    hi, ho, hr = (by[k]["h"][both].double() for k in ("in", "out", "ref"))
    return {"err": compare._rms((ho - hr) / hr),
            "change": compare._rms((hr - hi) / hr)}


def main(argv=None, device="cuda", n=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--segments", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", choices=faults.NAMES)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    c = Cell(args.workload, device, n)
    if args.fault:
        faults.plant(c.prog.integrate, args.fault)
    out = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            w = c.window(c.start(seed), seed, segments=args.segments)
            prog, ctrl, hr = [], [], []
            for _, d_in, d_out in c.samples(w):
                ref = c.reference(d_in)
                prog.append(c.compare(d_in, d_out, ref))
                if c.var_h:
                    hr.append(h_rel(d_in, d_out, ref))
                if k < args.control:
                    ctrl.append(c.compare(d_in, c.reference(
                        d_in, torch.bfloat16), ref))
            kind_prog = f"fault {args.fault}" if args.fault else "program"
            for kind, r in ((kind_prog, prog), ("control", ctrl)):
                if not r:
                    continue
                extra = ({"h_rel": compare.worst(hr)}
                         if hr and kind == kind_prog else {})
                line = json.dumps({
                    "workload": args.workload, "seed": seed, "kind": kind,
                    "readings": compare.worst(r), **extra,
                    "dt_mean": (w.t1 - w.t0) / w.steps,
                    "ms_per_step": w.window_s * 1e3 / w.steps,
                    "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
