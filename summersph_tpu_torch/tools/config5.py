"""Config 5 evidence run: the N = 1,048,576 self-gravitating collapse in
checkpointed segments.  Counterpart of `scripts/config5_run.py`, and of
the summary numbers of `scripts/config5_report.py`; both import JAX.

    python -m summersph_tpu_torch.tools.config5 [--fresh]
        [--steps-per-seg 16] [--max-wall 5400] [--ckpt-every 8]
        [--stop-t T] [--stop-dt DT] [--dt-bins B] [--device cuda]
    python -m summersph_tpu_torch.tools.config5 --report
        [--reference docs/results/collapse1m/ledger.csv]

A rotating cold cloud (a uniform ball of R = 50 AU and M = 50 M_sun in
rigid rotation at a rim speed of 4.2, u = 0.25, gamma = 1.1) collapses
under TreePM self-gravity (grid 128, the mesh solved every 4th step) with
variable h until the density threshold creates sinks (128 slots, merging).
Each segment is one `run_steps` call, then one row of `LEDGER_COLUMNS` in
`<out>/ledger.csv`, flushed.  `<out>/checkpoint.npz` is written every
`ckpt_every` segments, at the end, and when the state diverges (exit code
2).  Without `--fresh` a run resumes from that checkpoint.

Environment, as the script's: C5_OUT, the output directory (default
`docs/results/collapse1m_h100/`; point it outside the committed tree for
trials), C5_N, the particle count (default 1,048,576), C5_SMOKE=1, the
script's small form (grid 32, the mesh solved every step).  `--device`
(default `cuda`) raises without a card; `--device cpu` runs on the CPU.

The config's TPU window knobs and the script's resume overrides of them
(`--grav-fetch`, `--grav-window`, `--overflow-items`, `--sph-fetch`) are
kept and have no effect: the port's kernels walk every candidate.
`--report` prints the summary of `<out>/ledger.csv` and, with
`--reference`, the ledger held against another at matching t.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..config import SimConfig
from ..diagnostics import measure
from ..integrate import (SimulationDiverged, check_health, prime, run_steps,
                         warn_stats)
from ..io.checkpoint import load_npz_with_config, save_npz
from ..models.disc import disc_ic
from ..ops.timestep import dt_candidates
from ..state import STATS_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "docs", "results", "collapse1m_h100")
N_FULL = 1_048_576
T_END = 12.0   # ~1.4 free-fall times
T_FF = 8.8     # yr at the cloud's initial mean density 9.6e-5
RHO_SINK = 0.5  # the sink threshold m (eta / h)^3 > 0.5
LEDGER_COLUMNS = ["t", "dt", "n_gas", "n_sinks", "m_gas", "m_sinks",
                  "E_kin", "E_int", "px", "py", "pz", "Lz", "rho_max",
                  "h_min", "wall_s"]
# the script's resume overrides of TPU knobs: (flag, SimConfig field, unset)
TPU_OVERRIDES = (("grav_fetch", "grav_pallas_fetch", 0),
                 ("grav_window", "grav_pallas_window", 0),
                 ("overflow_items", "grav_overflow_items", -1),
                 ("sph_fetch", "pallas_fetch_window", 0))


def build(n: int = N_FULL, smoke: bool = False, device="cuda"):
    """(state, cfg) of the script's `build()` at N = n, field for field:
    h0 = (2^20 / n)^(1/3), the rim-h cap max_length = 1.5 h0 and the SPH
    cell at the 0.9 quantile of h; `smoke` takes the C5_SMOKE branches."""
    h0 = 1.0 * (N_FULL / n) ** (1.0 / 3.0)
    cfg = SimConfig(
        fixed_h=None, eta=1.2, h_iter_max=3, convergence_criteria=1e-3,
        max_length=1.5 * h0, cell_h_quantile=0.9,
        gravity="pm", grav_grid=32 if smoke else 128, theta=0.5,
        neighbor_mode="sorted", use_pallas=True, pallas_interpret=smoke,
        sorted_block=128, window_group=32,
        pallas_window=256, pallas_fetch_window=2560,
        grav_pallas_window=512 if smoke else 1024,
        grav_pallas_fetch=896 if smoke else 8448,
        grav_overflow_items=0 if smoke else 65536,
        window_blocks=3, grav_window_blocks=8,
        gamma=1.1, bounding_size=1500.0,
        sink_capacity=128, sink_merge_factor=1.0,
        kahan_u=True,
        pm_every=1 if smoke else 4,
        dt_init=1e-4, dt_min=1e-7, dt_max=5e-3,
        end_time=T_END,
    )
    state, _ = disc_ic(
        n=n, r_max=50.0, m_disc=50.0, m_star=0.0, u0=0.25,
        rotation="rigidbody", v_circ=4.2, h0=h0, cfg=cfg, seed=0,
        device=device)
    return state, cfg


def ledger_row(state, wall: float) -> list:
    """One ledger row in the script's formats, from `diagnostics.measure`
    (which sums in float64 whatever the state's dtype)."""
    d = measure(state)
    p, s = state.particles, state.sinks
    n_sinks = int(torch.sum(s.alive & (s.mass > 0)))
    mom = d["momentum"].tolist()
    return [f"{float(state.t):.6f}", f"{float(state.dt):.3e}",
            int(p.n_alive), n_sinks,
            f"{float(d['mass_gas']):.8f}", f"{float(d['mass_sinks']):.8f}",
            f"{float(d['e_kin']):.6f}", f"{float(d['e_int']):.6f}",
            f"{mom[0]:.3e}", f"{mom[1]:.3e}", f"{mom[2]:.3e}",
            f"{float(d['ang_momentum'][2]):.6f}",
            f"{float(d['rho_max']):.4e}",
            f"{float(d['h_min']):.4f}", f"{wall:.1f}"]


def _sync(state):
    if state.particles.pos.is_cuda:
        torch.cuda.synchronize(state.particles.pos.device)


def run_segments(state, cfg, out_dir, steps_per_seg=16, max_wall=5400.0,
                 ckpt_every=8, stop_t=0.0, stop_dt=0.0, t_end=T_END,
                 max_segments=0):
    """The script's segment loop on a primed `state`: `run_steps` segments
    until t >= t_end, the wall budget, a stop condition (t >= stop_t;
    dt < stop_dt once t > 1) or, when given, `max_segments` segments, each
    followed by a flushed row of `<out_dir>/ledger.csv` (its header when
    the file is new), `warn_stats`, the checkpoint every `ckpt_every`
    segments and `check_health`.  Returns (state, exit code): 0, or 2 when
    the state diverged; the checkpoint is written in both cases."""
    ledger = os.path.join(out_dir, "ledger.csv")
    ckpt = os.path.join(out_dir, "checkpoint.npz")
    new_ledger = not os.path.exists(ledger)
    worst = torch.zeros_like(state.stats)
    t_start = time.perf_counter()
    steps = seg = 0
    code = 0
    with open(ledger, "a", newline="") as fh:
        w = csv.writer(fh)
        if new_ledger:
            w.writerow(LEDGER_COLUMNS)
        while (float(state.t) < t_end
               and time.perf_counter() - t_start < max_wall
               and not (max_segments and seg >= max_segments)):
            t0 = time.perf_counter()
            print(f"[seg {seg}] dispatch t={float(state.t):.4f}",
                  flush=True)
            state = run_steps(state, cfg, steps_per_seg)
            _sync(state)   # the wall closes on the card's work
            wall = time.perf_counter() - t0
            steps += steps_per_seg
            row = ledger_row(state, wall)
            w.writerow(row)
            fh.flush()
            worst = torch.maximum(worst, state.stats)
            print(f"t={row[0]} dt={float(state.dt):.2e} N={row[2]} "
                  f"sinks={row[3]} m_sink={float(row[5]):.4f} "
                  f"rho_max={float(row[12]):.3e} h_min={row[13]} "
                  f"wall={wall:.3f}s ({steps_per_seg} steps, "
                  f"{wall / steps_per_seg * 1e3:.1f} ms/step)", flush=True)
            warn_stats(state)
            seg += 1
            if seg % ckpt_every == 0:
                save_npz(ckpt, state, cfg)
            t_now, dt_now = float(state.t), float(state.dt)
            if ((stop_t and t_now >= stop_t)
                    or (stop_dt and t_now > 1.0 and dt_now < stop_dt)):
                print(f"stop condition hit (t={t_now:.4f} dt={dt_now:.2e})",
                      flush=True)
                break
            try:
                check_health(state, where=f"after segment at t={row[0]}")
            except SimulationDiverged as e:
                print(f"ABORT: {e}", flush=True)
                code = 2
                break
    save_npz(ckpt, state, cfg)
    print(f"stopped at t={float(state.t):.4f} after {steps} steps "
          f"({time.perf_counter() - t_start:.1f}s wall); counters, maximum "
          f"over the segments: {dict(zip(STATS_FIELDS, worst.tolist()))}",
          flush=True)
    return state, code


def run(out_dir, steps_per_seg=16, max_wall=5400.0, ckpt_every=8,
        fresh=False, stop_t=0.0, stop_dt=0.0, dt_bins=0, device="cuda",
        n=N_FULL, smoke=False, overrides=None, max_segments=0) -> int:
    """The script's `main()` after its flags: build and prime (deleting an
    old ledger) when `fresh` or no checkpoint exists, else resume from
    `<out_dir>/checkpoint.npz` with `overrides` (SimConfig fields) and
    `dt_bins` on its config; then `run_segments`, for at most
    `max_segments` segments when that is given.  With dt_bins > 1 the
    base dt jumps to 2^(B-1) min(dt_candidates), capped at dt_max (the
    binned controller's relaxed bound).  Returns the exit code."""
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "checkpoint.npz")
    t_wall0 = time.perf_counter()

    def mark(msg):
        print(f"[{time.perf_counter() - t_wall0:7.1f}s] {msg}", flush=True)

    if os.path.exists(ckpt) and not fresh:
        state, cfg = load_npz_with_config(ckpt, device=device)
        over = dict(overrides or {})
        if dt_bins:
            over["dt_bins"] = dt_bins
        if over:
            cfg = cfg.with_(**over)
        if dt_bins > 1:
            cand = dt_candidates(state.particles, cfg)
            base = min((1 << (dt_bins - 1)) * float(torch.min(cand)),
                       cfg.dt_max)
            state = state.replace(dt=torch.tensor(
                base, dtype=state.dt.dtype, device=state.dt.device))
        mark(f"resumed t={float(state.t):.4f} dt={float(state.dt):.3e}"
             + (f" overrides={over}" if over else ""))
    else:
        state, cfg = build(n, smoke, device)
        mark(f"ICs built (N={n}, grav_grid={cfg.grav_grid}, on {device})")
        state = prime(state, cfg)
        _sync(state)
        mark("primed")
        ledger = os.path.join(out_dir, "ledger.csv")
        if os.path.exists(ledger):
            os.remove(ledger)
    _, code = run_segments(state, cfg, out_dir, steps_per_seg, max_wall,
                           ckpt_every, stop_t, stop_dt,
                           max_segments=max_segments)
    return code


# ------------------------------------------------- scripts/config5_report.py

def read_ledger(path) -> dict:
    """{column: float array} of a ledger, keeping the first row of each t:
    a killed pass can leave rows past its last checkpoint that the resumed
    pass runs again, so t is kept strictly increasing."""
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        raise SystemExit(f"{path} is empty")
    kept, t_max = [], -np.inf
    for r in rows:
        t = float(r["t"])
        if t > t_max:
            kept.append(r)
            t_max = t
    return {k: np.array([float(r[k]) for r in kept]) for k in kept[0]}


def summary(led: dict) -> dict:
    """The numbers of the script's SUMMARY.md: time reached, gas count,
    sinks and their mass, peak density, mass and |Lz| drift, dt range."""
    t = led["t"]
    m_tot = led["m_gas"] + led["m_sinks"]
    lz0 = led["Lz"][0]
    return {
        "t_end": float(t[-1]), "t_ff": float(t[-1] / T_FF),
        "n_gas_first": int(led["n_gas"][0]),
        "n_gas_last": int(led["n_gas"][-1]),
        "n_gas_min": int(led["n_gas"].min()),
        "sinks_max": int(led["n_sinks"].max()),
        "m_sinks_last": float(led["m_sinks"][-1]),
        "m_sinks_share": float(led["m_sinks"][-1] / m_tot[0]),
        "rho_max": float(led["rho_max"].max()),
        "mass_drift": float(abs(m_tot[-1] - m_tot[0]) / m_tot[0]),
        "lz_drift": float(abs(led["Lz"][-1] - lz0) / max(abs(lz0), 1e-12)),
        "dt_min": float(led["dt"].min()), "dt_max": float(led["dt"].max()),
        "first_sink_t": (float(t[np.argmax(led["n_sinks"] > 0)])
                         if led["n_sinks"].max() > 0 else None),
    }


def summary_lines(led: dict) -> list:
    """The script's summary bullets, in its formats, and the first sink."""
    s = summary(led)
    first = ("none" if s["first_sink_t"] is None
             else f"t = {s['first_sink_t']:.6f} yr")
    return [
        f"- time reached: t = {s['t_end']:.3f} yr = {s['t_ff']:.2f} t_ff "
        f"(t_ff = {T_FF} yr)",
        f"- gas particles: {s['n_gas_first']} -> {s['n_gas_last']} "
        f"(alive throughout: min {s['n_gas_min']})",
        f"- sinks formed: {s['sinks_max']} (final mass "
        f"{s['m_sinks_last']:.4f} M_sun = {100 * s['m_sinks_share']:.2f}% "
        f"of the cloud); first sink: {first}",
        f"- peak density: {s['rho_max']:.3e} (sink threshold {RHO_SINK}; "
        f"initial mean 9.6e-5)",
        f"- mass ledger drift: {s['mass_drift']:.2e} relative",
        f"- |Lz| drift: {s['lz_drift']:.2e} relative",
        f"- dt range: [{s['dt_min']:.2e}, {s['dt_max']:.2e}] yr",
    ]


def compare(led: dict, ref: dict, spans, columns=("E_kin", "E_int", "Lz",
                                                 "rho_max", "h_min")):
    """The ledger held against a reference ledger at matching t: for each
    (t_lo, t_hi) of `spans` and each column, the largest |ours - ref| /
    |ref| over our rows with t_lo <= t <= t_hi inside the reference's t
    range, the reference's column linearly interpolated in t.  Returns
    {(t_lo, t_hi): {"rows": k, column: deviation}}."""
    t = led["t"]
    inside = (t >= ref["t"][0]) & (t <= ref["t"][-1])
    out = {}
    for lo, hi in spans:
        sel = inside & (t >= lo) & (t <= hi)
        row = {"rows": int(sel.sum())}
        for c in columns:
            theirs = np.interp(t[sel], ref["t"], ref[c])
            dev = np.abs(led[c][sel] - theirs) / np.abs(theirs)
            row[c] = float(dev.max()) if sel.any() else float("nan")
        out[(lo, hi)] = row
    return out


def wall_by_span(led: dict, spans, steps_per_seg=16) -> dict:
    """For each (t_lo, t_hi) of `spans`, over the rows with t_lo < t <=
    t_hi: the rows, the simulated time they advance (from the row before
    the span's first), their summed wall seconds, the simulated years a
    wall second, and the median ms a step (`steps_per_seg` steps a row;
    base steps with block timesteps)."""
    t, wall = led["t"], led["wall_s"]
    out = {}
    for lo, hi in spans:
        sel = np.nonzero((t > lo) & (t <= hi))[0]
        if not sel.size:
            continue
        t0 = t[sel[0] - 1] if sel[0] > 0 else 0.0
        w = float(wall[sel].sum())
        out[(lo, hi)] = {"rows": int(sel.size),
                         "sim_t": float(t[sel[-1]] - t0), "wall_s": w,
                         "yr_per_s": float((t[sel[-1]] - t0) / w),
                         "ms_per_step": float(np.median(wall[sel]) * 1e3
                                              / steps_per_seg)}
    return out


def report(out_dir, reference=None) -> list:
    """The summary lines of `<out_dir>/ledger.csv` and its wall by span of
    t; with `reference` also, over our rows inside the reference's t
    range, the exact checks (n_gas equal to the reference's first on every
    row, m_gas to its first on every row without a sink) and `compare`
    through 1 t_ff and from it to the last common t."""
    led = read_ledger(os.path.join(out_dir, "ledger.csv"))
    lines = summary_lines(led)
    marks = [0.0, T_FF, float(led["t"][-1])]
    if reference:
        ref = read_ledger(reference)
        t_last = float(min(led["t"][-1], ref["t"][-1]))
        marks = sorted({0.0, min(T_FF, t_last), t_last, marks[-1]})
        inside = led["t"] <= ref["t"][-1]
        n0, m0 = int(ref["n_gas"][0]), ref["m_gas"][0]
        no_sink = inside & (led["n_sinks"] == 0)
        lines.append(
            f"- rows with t <= {ref['t'][-1]:.6f} ({int(inside.sum())}, "
            f"{int(no_sink.sum())} without a sink): n_gas = {n0} on every "
            f"one: {bool(np.all(led['n_gas'][inside] == n0))}; m_gas = "
            f"{m0:.8f} on every one without a sink: "
            f"{bool(np.all(led['m_gas'][no_sink] == m0))}")
        spans = [(lo, hi) for lo, hi in zip(marks, marks[1:])
                 if hi <= t_last]
        for (lo, hi), row in compare(led, ref, spans).items():
            lines.append(f"- against {reference}, {lo:.3f} <= t <= "
                         f"{hi:.3f} ({row.pop('rows')} rows), largest "
                         f"relative deviation: " + ", ".join(
                             f"{c} {v:.3e}" for c, v in row.items()))
    for (lo, hi), w in wall_by_span(led, list(zip(marks,
                                                  marks[1:]))).items():
        lines.append(f"- wall, {lo:.3f} < t <= {hi:.3f}: {w['rows']} "
                     f"segments, {w['sim_t']:.6f} yr in {w['wall_s']:.1f} s "
                     f"({w['yr_per_s']:.6f} yr a wall second), median "
                     f"{w['ms_per_step']:.1f} ms a step")
    return lines


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m summersph_tpu_torch.tools.config5",
        description="Config 5 evidence run in checkpointed segments")
    ap.add_argument("--steps-per-seg", type=int, default=16)
    ap.add_argument("--max-wall", type=float, default=5400.0)
    ap.add_argument("--ckpt-every", type=int, default=8)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--grav-fetch", type=int, default=0,
                    help="override grav_pallas_fetch on resume (no effect)")
    ap.add_argument("--grav-window", type=int, default=0,
                    help="override grav_pallas_window on resume (no effect)")
    ap.add_argument("--overflow-items", type=int, default=-1,
                    help="override grav_overflow_items on resume "
                         "(no effect)")
    ap.add_argument("--sph-fetch", type=int, default=0,
                    help="override pallas_fetch_window on resume "
                         "(no effect)")
    ap.add_argument("--stop-dt", type=float, default=0.0,
                    help="stop once dt < this (after t > 1)")
    ap.add_argument("--stop-t", type=float, default=0.0,
                    help="stop once t >= this")
    ap.add_argument("--dt-bins", type=int, default=0,
                    help="override cfg.dt_bins on resume (block timesteps)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which needs a card)")
    ap.add_argument("--report", action="store_true",
                    help="print the summary of the ledger in C5_OUT and "
                         "run nothing")
    ap.add_argument("--reference",
                    help="with --report: a ledger to hold this one against")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out_dir = os.environ.get("C5_OUT") or DEFAULT_OUT
    if args.report:
        print("\n".join(report(out_dir, args.reference)), flush=True)
        return 0
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(
            f"--device {args.device}: torch sees no CUDA card; pass "
            f"--device cpu to run on the CPU")
    overrides = {field: getattr(args, flag)
                 for flag, field, unset in TPU_OVERRIDES
                 if getattr(args, flag) != unset}
    return run(out_dir, args.steps_per_seg, args.max_wall, args.ckpt_every,
               args.fresh, args.stop_t, args.stop_dt, args.dt_bins,
               args.device, n=int(os.environ.get("C5_N", N_FULL)),
               smoke=os.environ.get("C5_SMOKE", "0") == "1",
               overrides=overrides)


if __name__ == "__main__":
    raise SystemExit(main())
