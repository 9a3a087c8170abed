"""Graded configuration 1: the Sod shock tube's L2 density error.
Counterpart of `scripts/sod_evidence.py`, which imports JAX.

    python -m summersph_tpu_torch.tools.sod_evidence [--device cuda]
        [--out DIR]
    python -m summersph_tpu_torch.tools.sod_evidence --render DIR

Runs the tube to t = 0.1 at n = 400 and 800 on the 'grid' and 'sorted'
neighbour engines (`run_case`, the script's configs field for field) and
writes `<out>/README.md` (default `docs/results/sod_h100/`): the L2 error
against the exact Riemann solution beside the JAX package's value from
`docs/results/sod/README.md`, and the wall of each case.  In the port
'grid' runs on the sorted engine and its kernels too (its `cell_cap` has
no effect), so the two engines differ only in their configs'
`sorted_block`, `window_group` and `window_blocks`.  The profiles at n =
1,000 and t = 0.2 go to `<out>/profiles.npz`; `--render DIR` draws
`sod_profiles.png` from it where matplotlib is (the card's machine has
none).  `--device` (default cuda) raises without a card.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..integrate import run_until
from ..models.sod import sod_config, sod_exact, sod_ic, sod_l2_density_error
from .config5 import _sync
from .evidence import RESULTS, card_line

CASES = [(400, "grid"), (400, "sorted"), (800, "grid"), (800, "sorted")]
# docs/results/sod/README.md: the JAX package's L2 at t = 0.1, either engine
JAX_L2 = {400: 0.01383, 800: 0.01235}
L2_BOUND = 5e-4   # |L2 - JAX_L2|, stated before the card's runs


def case_config(n, mode, end_time=0.1):
    """The script's config of one case."""
    kw = dict(end_time=end_time)
    if mode == "grid":
        kw.update(neighbor_mode="grid", cell_cap=96 if n <= 400 else 192)
    else:
        kw.update(neighbor_mode="sorted", sorted_block=128, window_group=32,
                  window_blocks=4)
    return sod_config(n=n).with_(**kw)


def run_case(n, mode, device="cuda"):
    """The script's `run_case`: the tube at n on `mode` to t = 0.1 with
    `run_until`.  Returns (L2 density error, wall seconds); raises when a
    particle was lost."""
    cfg = case_config(n, mode)
    state, _ = sod_ic(n=n, cfg=cfg, device=device)
    t0 = time.perf_counter()
    state = run_until(state, 0.1, cfg)
    _sync(state)
    wall = time.perf_counter() - t0
    err = float(sod_l2_density_error(state))
    alive = int(state.particles.n_alive)
    if alive != n:
        raise RuntimeError(f"Sod n={n} {mode}: {alive} of {n} alive")
    return err, wall


def profiles(n=1000, device="cuda", t_end=0.2) -> dict:
    """The script's `plot_profiles` run: the tube at n on the sorted
    engine to t_end; x, density, velocity and pressure of the particles in
    x order."""
    cfg = case_config(n, "sorted", end_time=t_end)
    state, _ = sod_ic(n=n, cfg=cfg, device=device)
    state = run_until(state, t_end, cfg)
    p = state.particles
    x = p.pos[:, 0].cpu().numpy()
    order = np.argsort(x)
    return {"n": n, "t": float(state.t), "x": x[order],
            "rho": p.rho.cpu().numpy()[order],
            "v": p.vel[:, 0].cpu().numpy()[order],
            "pressure": p.pressure.cpu().numpy()[order]}


def render(out_dir) -> str:
    """Draw `sod_profiles.png` (the script's three panels against the
    exact solution at t = 0.2) from `<out_dir>/profiles.npz`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = np.load(os.path.join(out_dir, "profiles.npz"))
    n = int(z["n"])
    xe = np.linspace(-0.5, 0.5, 1000)
    re, ve, pe = sod_exact(xe, 0.2)
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    for ax, (sim, exact, name) in zip(axes, [(z["rho"], re, "density"),
                                             (z["v"], ve, "velocity"),
                                             (z["pressure"], pe,
                                              "pressure")]):
        ax.plot(xe, exact, "k-", lw=1, label="exact Riemann")
        ax.plot(z["x"], sim, ".", ms=2.5, label=f"SPH n={n}")
        ax.set_xlabel("x")
        ax.set_title(f"{name}, t=0.2")
        ax.set_xlim(-0.5, 0.5)
    axes[0].legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    png = os.path.join(out_dir, "sod_profiles.png")
    fig.savefig(png, dpi=110)
    plt.close(fig)
    return png


def run(out_dir, device="cuda") -> int:
    """The four cases, the profiles and the README.  Returns 0, or 1 when
    an L2 lies outside L2_BOUND of the JAX package's."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for n, mode in CASES:
        err, wall = run_case(n, mode, device)
        print(f"n={n} engine={mode}: L2={err:.5f} ({wall:.1f}s)", flush=True)
        rows.append((n, mode, err, wall))
    t0 = time.perf_counter()
    prof = profiles(1000, device)
    prof_s = time.perf_counter() - t0
    np.savez_compressed(os.path.join(out_dir, "profiles.npz"), **prof)
    held = all(abs(err - JAX_L2[n]) <= L2_BOUND for n, _, err, _ in rows)
    engine = ("the CUDA kernels" if torch.device(device).type == "cuda"
              else "the plain PyTorch versions on the CPU")
    lines = [
        "# Graded config 1: the Sod shock tube on the PyTorch port",
        "",
        f"- card: {card_line(device)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}",
        "- setup: `models/sod.py`'s tube, (rho, P) = (1, 1) | (0.125, 0.1), "
        "gamma 1.4, run to t = 0.1 by `run_until` (adaptive dt, the "
        "Morris-Monaghan switch), the configs of `scripts/sod_evidence.py`",
        f"- both engines run on the sorted engine and {engine}: the port "
        "runs 'grid' on the sorted engine (its cell_cap has no effect), so "
        "the two differ only in sorted_block, window_group and "
        "window_blocks",
        "",
        "## L2 density error against the exact Riemann solution (t = 0.1)",
        "",
        f"| n | engine | L2 | JAX package (`docs/results/sod`) | "
        f"within {L2_BOUND:g} | wall s (the build excluded) |",
        "|---|---|---|---|---|---|",
    ]
    lines += [f"| {n} | {mode} | {err:.5f} | {JAX_L2[n]:.5f} | "
              f"{'yes' if abs(err - JAX_L2[n]) <= L2_BOUND else 'NO'} | "
              f"{wall:.2f} |" for n, mode, err, wall in rows]
    lines += [
        "",
        "![profiles](sod_profiles.png)",
        "",
        f"Profiles at t = {prof['t']:.4f} (n = 1000, sorted engine, "
        f"{prof_s:.1f} s) against the exact solution at t = 0.2: "
        "`profiles.npz`, drawn into `sod_profiles.png` by `--render`.",
        "",
        "Written by `python -m summersph_tpu_torch.tools.sod_evidence`.",
    ]
    with open(os.path.join(out_dir, "README.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {out_dir}; every L2 within {L2_BOUND:g} of the JAX "
          f"package's: {held}", flush=True)
    return 0 if held else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m summersph_tpu_torch.tools.sod_evidence",
        description="The Sod shock tube's L2 table and profiles")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which needs a card)")
    ap.add_argument("--out", default=os.path.join(RESULTS, "sod_h100"))
    ap.add_argument("--render", metavar="DIR",
                    help="draw sod_profiles.png of a run's directory and "
                         "run nothing")
    args = ap.parse_args(argv)
    if args.render:
        print(f"wrote {render(args.render)}", flush=True)
        return 0
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(
            f"--device {args.device}: torch sees no CUDA card; pass "
            f"--device cpu to run on the CPU")
    if torch.device(args.device).type == "cuda":
        from ..utils import build
        build.load("sph_pairs")   # the build stays out of the first wall
    return run(args.out, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
