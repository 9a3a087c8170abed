"""Evidence runs of graded configurations 2-4: the thin ring, the Keplerian
disc with TreePM and a sink, and the variable-h disc.  Counterpart of
`scripts/evidence_runs.py`, which imports JAX.

    python -m summersph_tpu_torch.tools.evidence
        [--config ring|disc100|varh|all] [--smoke] [--seg-steps 64]
        [--max-wall 1800] [--t-end T] [--device cuda] [--out DIR]
    python -m summersph_tpu_torch.tools.evidence --render DIR

  ring    - N = 4,000 narrow annulus on Keplerian orbits around a 1 M_sun
            sink, no self-gravity, fixed h = 2, to 350 yr: pressure and
            viscosity spread it while L_z is conserved.
  disc100 - N = 12,000 uniform sphere on Keplerian velocities around a
            central 5 M_sun sink, TreePM (grid 128, the separate short
            range, the mesh solved every step), fixed h = 2.5, to 100 yr.
  varh    - N = 20,000 of the same, with grad-h variable h and the Newton
            h-iteration (the SPH cell at the 0.9 quantile of h, h capped at
            20 AU), to 20 yr (`--t-end 100` deepens it as the JAX run was).

Each run builds the script's state and config (`BUILDERS`, field for
field; the TPU window knobs are kept and have no effect), primes, then
runs `tools.config5.run_segments`: segments of `seg_steps` steps, each
followed by one 15-column row of `<out>/ledger.csv`, until end_time or the
wall budget; exit code 2 when the state diverges.  The card's machine has
no matplotlib, so a run writes what the figures need into
`<out>/panels.npz` (the radial surface-density profiles at t0, mid and
end, varh's h against r at the end, the discs' 120 x 120 density
projections at t0 and end; also each segment's wall unrounded, the SPH
candidates tested per row after it, and the primed state's ledger row,
`row0`) and `<out>/README.md`: the script's numbers,
the wall, the SPH candidates each row tested, and, at full size, the
ledger held against the JAX run's `docs/results/<name>/ledger.csv` and
against the bounds of `BOUNDS`.  `--render DIR` draws `evolution.png` and
the discs' `density_{t0,end}.png` from those files, where matplotlib is.

`--out` is the parent of each config's `<name>_h100/` (default: EV_OUT,
as the script reads it, else docs/results).  `--device` (default cuda)
raises without a card; `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from ..config import SimConfig
from ..diagnostics import measure
from ..integrate import prime
from ..models.disc import disc_ic
from ..models.ring import ring_ic
from ..ops.sorted_grid import sort_h_pad, sort_particles
from .config5 import (LEDGER_COLUMNS, _sync, compare, ledger_row,
                      read_ledger, run_segments)
from .density_image import projected_density, save_image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(ROOT, "docs", "results")
IMAGED = ("disc100", "varh")   # the configs with density projections
PROFILE_BINS = 40


def _pallas_cfg(smoke):
    """The script's production neighbour engine; interpret mode under
    --smoke (a TPU knob: no effect here)."""
    return dict(neighbor_mode="sorted", use_pallas=True,
                pallas_interpret=bool(smoke))


def build_ring(smoke=False, device="cuda"):
    n = 512 if smoke else 4000
    cfg = SimConfig(fixed_h=2.0, gravity="none", gamma=1.4,
                    bounding_size=1500.0, end_time=30.0 if smoke else 350.0,
                    dt_init=1e-2, **_pallas_cfg(smoke))
    state, _ = ring_ic(n=n, r0=50.0, width=5.0, m_ring=0.01, m_star=1.0,
                       u0=1.0e-4, h0=2.0, cfg=cfg, seed=0, device=device)
    return state, cfg


def build_disc100(smoke=False, device="cuda"):
    n = 1024 if smoke else 12000
    cfg = SimConfig(fixed_h=2.5, gravity="pm", grav_grid=32 if smoke else 128,
                    gamma=1.4, bounding_size=1500.0,
                    end_time=10.0 if smoke else 100.0, dt_init=1e-3,
                    **_pallas_cfg(smoke))
    state, _ = disc_ic(n=n, r_max=100.0, m_disc=5.0, m_star=5.0, u0=0.25,
                       rotation="keplerian", h0=2.5, sink_radius=3.5,
                       cfg=cfg, seed=0, device=device)
    return state, cfg


def build_varh(smoke=False, device="cuda"):
    n = 1024 if smoke else 20000
    cfg = SimConfig(fixed_h=None, eta=1.2, h_iter_max=3,
                    convergence_criteria=1e-3, max_length=20.0,
                    cell_h_quantile=0.9,
                    gravity="pm", grav_grid=32 if smoke else 128,
                    gamma=1.4, bounding_size=1500.0,
                    end_time=4.0 if smoke else 20.0, dt_init=1e-3,
                    pallas_fetch_window=2560,
                    grav_pallas_fetch=2560 if smoke else 3456,
                    grav_overflow_items=0 if smoke else 65536,
                    **_pallas_cfg(smoke))
    state, _ = disc_ic(n=n, r_max=100.0, m_disc=5.0, m_star=5.0, u0=0.25,
                       rotation="keplerian", h0=5.0, sink_radius=3.5,
                       cfg=cfg, seed=0, device=device)
    return state, cfg


BUILDERS = {"ring": build_ring, "disc100": build_disc100, "varh": build_varh}

# The bounds stated before the card's runs (PERF.md): every-row checks,
# per-row deviations from the JAX ledger at matching t over (t_lo, t_hi),
# and [lo, hi] of the end numbers of `readme_numbers`.
BOUNDS = {
    "ring": {
        "every_row": {"n_gas": 4000, "m_gas": 0.01, "m_sinks": 1.0},
        "rows": {(0.0, np.inf): {"E_kin": 1e-3, "Lz": 1e-3,
                                 "rho_max": 0.10}},
        "end": {"lz_drift_rel": (0.0, 1e-4)},
    },
    "disc100": {
        "rows": {(0.0, 10.0): {"E_kin": 1e-3, "E_int": 1e-3, "Lz": 1e-3},
                 (0.0, np.inf): {"E_kin": 1e-2, "E_int": 1e-2, "Lz": 1e-2}},
        "end": {"n_gas": (11946 - 24, 11946 + 24),
                "accreted": (0.75 * 0.022088, 1.25 * 0.022088),
                "mass_drift": (0.0, 1.3e-3), "escapers": (0, 3),
                "lz_drift_pct": (0.06, 0.25)},
    },
    "varh": {
        "rows": {(0.0, 10.0): {"E_kin": 1e-3, "E_int": 1e-3, "Lz": 1e-3},
                 (0.0, np.inf): {"E_kin": 1e-2, "E_int": 1e-2, "Lz": 1e-2}},
        "end": {"n_gas": (19813 - 40, 19813 + 40),
                "accreted": (0.75 * 0.046731, 1.25 * 0.046731),
                "mass_drift": (0.0, 1.3e-3),
                "lz_drift_pct": (0.09, 0.36),
                "h_min": (0.95 * 3.576, 1.05 * 3.576)},
    },
}


def radial_profile(state, bins=PROFILE_BINS):
    """The script's `_radial_profile`: (bin centres, Sigma(r) = dM / (2 pi
    r dr)) of the live gas in cylindrical radius."""
    p = state.particles
    alive = p.alive.cpu().numpy()
    pos = p.pos.cpu().numpy()[alive]
    m = p.mass.cpu().numpy()[alive]
    r = np.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    hist, edges = np.histogram(r, bins=bins, weights=m)
    centers = 0.5 * (edges[:-1] + edges[1:])
    sigma = hist / (2.0 * np.pi * np.maximum(centers, 1e-9) * np.diff(edges))
    return centers, sigma


def h_vs_r(state):
    """The script's `_h_vs_r`: spherical radius and h of the live gas."""
    p = state.particles
    alive = p.alive.cpu().numpy()
    pos = p.pos.cpu().numpy()[alive]
    return np.sqrt(np.sum(pos * pos, axis=1)), p.h.cpu().numpy()[alive]


def candidates_per_row(state, cfg) -> float:
    """The SPH candidates each row of the state's sort tests: every window
    group's 9 ranges, averaged over the groups (the kernels test them all,
    where the JAX plan covered a static window)."""
    _, grid = sort_particles(state.particles, cfg, h_pad=sort_h_pad(cfg))
    return float((grid.ends - grid.starts).sum(dim=1).double().mean())


def card_line(device) -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints it; "cpu" off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[dev.index or 0]


def readme_numbers(led: dict, d0: dict) -> dict:
    """The numbers of the script's README from a ledger (`read_ledger`)
    and the t0 measures `d0` (n_gas, mass_gas, mass_sinks): the masses,
    L_z and the final values from the ledger's first and last rows, as the
    script takes them from its rows and its end measure."""
    m0 = d0["mass_gas"] + d0["mass_sinks"]
    m1 = float(led["m_gas"][-1] + led["m_sinks"][-1])
    lz0, lz1 = float(led["Lz"][0]), float(led["Lz"][-1])
    accreted = float(led["m_sinks"][-1]) - d0["mass_sinks"]
    n0, n1 = int(d0["n_gas"]), int(led["n_gas"][-1])
    drift = abs(lz1 - lz0) / abs(lz0) if lz0 else 0.0
    return {"n0": n0, "t_end": float(led["t"][-1]), "rows": len(led["t"]),
            "m0": m0, "m1": m1, "mass_drift": abs(m1 - m0),
            "accreted": accreted, "n_sinks": int(led["n_sinks"][-1]),
            "lz0": lz0, "lz1": lz1, "lz_drift_rel": drift,
            "lz_drift_pct": drift * 100.0, "n_gas": n1,
            "escapers": n0 - n1 - round(accreted * n0 / d0["mass_gas"]),
            "rho_max": float(led["rho_max"][-1]),
            "h_min": float(led["h_min"][-1])}


def readme_lines(num: dict) -> list:
    """The script's README bullets after its engine line, in its formats."""
    return [
        f"- N0 = {num['n0']} gas, ran t = 0 -> {num['t_end']:.2f} yr "
        f"({num['rows']} ledger segments)",
        f"- gas+sink mass ledger: {num['m0']:.6f} -> {num['m1']:.6f} M_sun "
        f"(drift {num['mass_drift']:.2e}; remainder = bounds-culled "
        f"escapers)",
        f"- sink accretion: {num['accreted']:.6f} M_sun onto "
        f"{num['n_sinks']} sink(s)",
        f"- L_z: {num['lz0']:.6f} -> {num['lz1']:.6f} "
        f"({num['lz_drift_pct']:.3f}% drift)",
        f"- final n_gas = {num['n_gas']}, rho_max = {num['rho_max']:.3e}, "
        f"h_min = {num['h_min']:.3f}",
    ]


def jax_reference(name, row0) -> dict:
    """The JAX run's ledger (`docs/results/<name>/ledger.csv`) with the
    t0 row `row0` (this run's, from the ICs, which both packages make
    alike) in front, so that a first row a rounding short of the
    reference's first t is held too."""
    ref = read_ledger(os.path.join(RESULTS, name, "ledger.csv"))
    return {k: np.concatenate([[row0[k]], v]) for k, v in ref.items()}


def held_lines(name, led, ref, num) -> list:
    """Each bound of BOUNDS[name] with this run's value: the every-row
    checks, the largest deviation from `ref` at matching t over each span,
    and the end numbers."""
    bounds = BOUNDS[name]
    out = []

    def line(what, value, ok, bound):
        out.append(f"- {what}: {value} (bound {bound}): "
                   + ("held" if ok else "NOT HELD"))

    for col, want in bounds.get("every_row", {}).items():
        bad = int(np.sum(led[col] != want))
        line(f"{col} = {want} on every row", f"{bad} rows differ", bad == 0,
             "0 rows")
    t_last = float(min(led["t"][-1], ref["t"][-1]))
    for (lo, hi), cols in bounds["rows"].items():
        span = (lo, min(hi, t_last))
        dev = compare(led, ref, [span], columns=tuple(cols))[span]
        for col, tol in cols.items():
            line(f"{col}, {span[0]:g} <= t <= {span[1]:.3f} ({dev['rows']} "
                 f"rows), largest relative deviation", f"{dev[col]:.3e}",
                 dev[col] <= tol, f"{tol:g}")
    for key, (lo, hi) in bounds["end"].items():
        line(key, f"{num[key]:.6g}", lo <= num[key] <= hi,
             f"[{lo:.6g}, {hi:.6g}]")
    return out


def run(name, state, cfg, out_dir, seg_steps=64, max_wall=1800.0,
        max_segments=0, smoke=False):
    """The script's `run_config` on a built state: prime, the t0 panels,
    `run_segments` (at most `max_segments` segments when given), the
    panels at the first row past half of end_time and at the end, then
    `<out_dir>/panels.npz` and README.md.  Returns (state, exit code)."""
    os.makedirs(out_dir, exist_ok=True)
    ledger = os.path.join(out_dir, "ledger.csv")
    if os.path.exists(ledger):
        os.remove(ledger)
    device = state.particles.pos.device
    imaged = name in IMAGED and not smoke
    t_wall0 = time.perf_counter()
    state = prime(state, cfg)
    _sync(state)
    prime_s = time.perf_counter() - t_wall0
    d = measure(state)
    d0 = {k: float(d[k]) for k in ("n_gas", "mass_gas", "mass_sinks")}
    row0 = dict(zip(LEDGER_COLUMNS, map(float, ledger_row(state, 0.0))))
    profiles = [(float(state.t), *radial_profile(state))]
    panels = {}

    def image(st, label):
        proj, xi, sxy = projected_density(st.particles, st.sinks,
                                          h=cfg.fixed_h, resolution=120,
                                          box=110.0, device=device)
        panels.update({f"image_{label}": proj, "image_xi": xi,
                       f"image_sinks_{label}": sxy,
                       f"image_time_{label}": float(st.t)})

    if imaged:
        image(state, "t0")
    walls, tested = [], []

    def on_segment(st, row, wall):
        walls.append(wall)
        tested.append(candidates_per_row(st, cfg))
        print(f"[{name}] SPH candidates tested per row {tested[-1]:.1f}",
              flush=True)
        if len(profiles) == 1 and float(st.t) >= 0.5 * cfg.end_time:
            profiles.append((float(st.t), *radial_profile(st)))

    state, code = run_segments(state, cfg, out_dir, seg_steps, max_wall,
                               t_end=cfg.end_time,
                               max_segments=max_segments,
                               on_segment=on_segment)
    if code:
        return state, code
    total_s = time.perf_counter() - t_wall0
    profiles.append((float(state.t), *radial_profile(state)))
    if name == "varh":
        panels["h_r"], panels["h_h"] = h_vs_r(state)
    if imaged:
        image(state, "end")
    card = card_line(device)
    np.savez_compressed(
        os.path.join(out_dir, "panels.npz"), name=name, smoke=smoke,
        device=card, n0=int(d0["n_gas"]), t_final=float(state.t),
        profile_t=np.array([p[0] for p in profiles]),
        profile_r=np.stack([p[1] for p in profiles]),
        profile_sigma=np.stack([p[2] for p in profiles]),
        seg_wall=np.array(walls), tested_per_row=np.array(tested),
        row0=np.array([row0[c] for c in LEDGER_COLUMNS]), **panels)
    led = read_ledger(ledger)
    num = readme_numbers(led, d0)
    lines = [f"# {name} evidence run of the PyTorch port", ""]
    engine = ("the sorted engine and the CUDA kernels"
              if device.type == "cuda" else
              "the sorted engine, plain PyTorch versions on the CPU")
    lines += [
        f"- engine: {'SMOKE (tiny N), ' if smoke else ''}{engine}, "
        f"gravity={cfg.gravity}, "
        + (f"fixed h={cfg.fixed_h:g}" if cfg.fixed_h is not None
           else "variable h (grad-h + Newton)"),
        f"- card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}",
        *readme_lines(num),
    ]
    walls_a = np.array(walls)
    rate = float(np.sum(led["n_gas"]) * seg_steps / walls_a.sum())
    lines += [
        f"- wall: {walls_a.sum():.1f} s in {len(walls)} segments of "
        f"{seg_steps} steps to t = {float(state.t):.2f} yr; "
        f"{total_s:.1f} s from the prime to the end, the prime "
        f"({prime_s:.1f} s, the kernels' build included) and the panels "
        f"outside the segments; median "
        f"{np.median(walls_a) / seg_steps * 1e3:.2f} ms a step (the "
        f"ledger's wall column, unrounded in panels.npz, over {seg_steps}); "
        f"{rate:.6e} particle-steps/s (live gas x steps over the segments' "
        f"wall)",
        f"- SPH candidates tested per row (every window group's 9 ranges): "
        f"{tested[0]:.1f} after the first segment, {max(tested):.1f} at "
        f"most, {tested[-1]:.1f} at the end",
    ]
    if not smoke:
        ref = jax_reference(name, row0)
        lines += ["", f"## Against the JAX run (`docs/results/{name}/"
                  f"ledger.csv`) at matching t, and the bounds stated "
                  f"before the run", ""]
        lines += held_lines(name, led, ref, num)
    lines += [
        "",
        "Artifacts: `ledger.csv` (per-segment conservation ledger), "
        "`panels.npz` (the figures' data), `evolution.png` (population / "
        "mass / L_z / dt / rho_max panels"
        + (", h-vs-r adaptation)" if name == "varh" else
           ", radial surface-density spreading)" if name == "ring" else ")")
        + (", `density_t0.png` / `density_end.png` (SPH density "
           "projections)" if imaged else "") + ".",
        "",
        f"Written by `python -m summersph_tpu_torch.tools.evidence --config "
        f"{name}` (end_time {cfg.end_time:g}, {seg_steps} steps a segment); "
        f"the figures by `--render` on this directory.",
    ]
    with open(os.path.join(out_dir, "README.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"[{name}] evidence written to {out_dir}", flush=True)
    return state, 0


def run_config(name, smoke=False, seg_steps=64, max_wall=1800.0, t_end=0.0,
               device="cuda", out_dir=None, max_segments=0):
    """BUILDERS[name] on `device` (end_time replaced by `t_end` when given),
    then `run` into `out_dir` (default `<EV_OUT or docs/results>/
    <name>_h100`).  Returns (state, cfg, exit code)."""
    state, cfg = BUILDERS[name](smoke, device)
    if t_end:
        cfg = cfg.with_(end_time=t_end)
    out_dir = out_dir or os.path.join(os.environ.get("EV_OUT") or RESULTS,
                                      f"{name}_h100")
    state, code = run(name, state, cfg, out_dir, seg_steps, max_wall,
                      max_segments, smoke)
    return state, cfg, code


def render(out_dir) -> list:
    """Draw `evolution.png` (the script's 2 x 3 panels) and, where
    panels.npz holds them, `density_t0.png` / `density_end.png` from
    `<out_dir>/ledger.csv` and `panels.npz`.  Returns the files written."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    led = read_ledger(os.path.join(out_dir, "ledger.csv"))
    z = np.load(os.path.join(out_dir, "panels.npz"))
    name, smoke = str(z["name"]), bool(z["smoke"])
    t = led["t"]
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    ax = axes[0, 0]
    ax.plot(t, led["n_gas"], label="n_gas")
    ax.set_ylabel("live gas")
    ax2 = ax.twinx()
    ax2.plot(t, led["n_sinks"], color="C3", label="sinks")
    ax2.set_ylabel("sinks", color="C3")
    ax.set_title("population")

    ax = axes[0, 1]
    ax.plot(t, led["m_gas"], label="gas")
    ax.plot(t, led["m_sinks"], label="sinks")
    ax.plot(t, led["m_gas"] + led["m_sinks"], "k--", label="total")
    ax.legend()
    ax.set_title("mass ledger [M_sun]")

    ax = axes[0, 2]
    lz0 = led["Lz"][0] if led["Lz"][0] != 0 else 1.0
    ax.plot(t, (led["Lz"] - led["Lz"][0]) / abs(lz0) * 100.0)
    ax.set_ylabel("%")
    ax.set_title("L_z drift [%]")

    ax = axes[1, 0]
    ax.semilogy(t, led["dt"])
    ax.set_title("dt [yr]")
    ax.set_xlabel("t [yr]")

    ax = axes[1, 1]
    ax.semilogy(t, np.maximum(led["rho_max"], 1e-12))
    ax.set_title("rho_max")
    ax.set_xlabel("t [yr]")

    ax = axes[1, 2]
    if name == "varh":
        ax.plot(z["h_r"], z["h_h"], ".", ms=1, alpha=0.3)
        ax.set_xlabel("r [AU]")
        ax.set_ylabel("h [AU]")
        ax.set_title("smoothing length vs radius (end)")
    else:
        for tp, c, s in zip(z["profile_t"], z["profile_r"],
                            z["profile_sigma"]):
            ax.plot(c, s, label=f"t={tp:.0f}")
        ax.legend()
        ax.set_xlabel("r_cyl [AU]")
        ax.set_ylabel("Sigma(r)")
        ax.set_title("radial surface density")
    fig.suptitle(f"{name}: N0={int(z['n0'])}, t={float(z['t_final']):.1f} "
                 f"yr, {'SMOKE' if smoke else 'production'} on "
                 f"{str(z['device'])}")
    fig.tight_layout()
    written = [os.path.join(out_dir, "evolution.png")]
    fig.savefig(written[0], dpi=120)
    plt.close(fig)
    for label in ("t0", "end"):
        if f"image_{label}" in z:
            png = os.path.join(out_dir, f"density_{label}.png")
            save_image(z[f"image_{label}"], z["image_xi"],
                       z[f"image_sinks_{label}"], png,
                       title=f"{name} t={float(z[f'image_time_{label}']):.1f}"
                             f" yr")
            written.append(png)
    return written


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m summersph_tpu_torch.tools.evidence",
        description="Evidence runs of graded configurations 2-4")
    ap.add_argument("--config", default="all",
                    choices=["all"] + sorted(BUILDERS))
    ap.add_argument("--smoke", action="store_true",
                    help="the script's tiny-N forms")
    ap.add_argument("--seg-steps", type=int, default=64)
    ap.add_argument("--max-wall", type=float, default=1800.0)
    ap.add_argument("--t-end", type=float, default=0.0,
                    help="replace the builder's end_time")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which needs a card)")
    ap.add_argument("--out", help="parent of each config's <name>_h100/ "
                                  "(default: EV_OUT, else docs/results)")
    ap.add_argument("--render", metavar="DIR",
                    help="draw the figures of a run's directory and run "
                         "nothing")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.render:
        for png in render(args.render):
            print(f"wrote {png}", flush=True)
        return 0
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(
            f"--device {args.device}: torch sees no CUDA card; pass "
            f"--device cpu to run on the CPU")
    base = args.out or os.environ.get("EV_OUT") or RESULTS
    names = sorted(BUILDERS) if args.config == "all" else [args.config]
    for name in names:
        _, _, code = run_config(name, args.smoke, args.seg_steps,
                                args.max_wall, args.t_end, args.device,
                                os.path.join(base, f"{name}_h100"))
        if code:
            return code
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
