#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (`summersph_tpu_torch`).

    python3 sphbench/run.py --workload NAME --seed N --seconds S --trace 0|1

(also `python -m sphbench.run ...`).  A cell (`workloads/<name>.json`)
names a configuration (`configs/<config>.json`: the `SimConfig` fields,
the initial-condition parameters, the particle count) and a traffic mix
(`traffic/<traffic>.json`: how the window drives the program).  Per-layer
metric readers are the modules `metrics/<metric>.py` that list the cell.

Set-up: initial conditions from the seed on the card (`ics.py`),
`integrate.prime`, then warm-up segments; the first run in a checkout
also builds the CUDA kernels with nvcc into the program's fixed
`summersph_tpu_torch/_build/`.  The window then runs the loop of
`integrate.run_until` for `--seconds`: `run_steps(state, cfg, 8)` and its
one host read of `t`, segment after segment; an operation is a segment,
and it failed when the program's health counters report a non-finite
value or dropped pairs after it.  With `--trace 1` the first
`trace_segments` segments run under `torch.profiler` (the card's
activity) and the per-layer metrics are printed instead of the
end-to-end ones; the readers get the states at the two ends of that
traced span (`Cell.context`), whatever the window did after it.

After the window: the memory peak is read, the program's state freed,
and a sample of the window's segments, drawn from the seed, is run again
by the plain reference (`reference.py`) from the same input state and
held against what the program produced (`compare.py`).  The last lines
on standard error are the compared numbers beside their limits; the last
line on standard output is the result, one JSON object.  Without a card,
or with fewer cards than the cell asks for, it prints no result and
exits 2.  Where the process holds JAX or the JAX package once the window
and the reference have run (`jax_modules`), it names them on standard
error, prints no result and exits 3: the port is measured without them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "summersph_tpu_torch"
PROGRAM_MODULES = ("integrate", "state", "config", "ops.sorted_grid",
                   "ops.cuda_pairs", "ops.smoothing", "ops.pm_gravity",
                   "ops.gravity", "ops.sinks")
# the health counters (state.STATS_FIELDS, found by name) whose nonzero
# value fails a segment
FAULT_COUNTERS = ("sph_window_overflow", "grav_window_overflow", "nonfinite")
CACHE_DIR = ROOT / ".sphbench_cache"
# top-level modules that no run may hold: JAX and the JAX package that the
# port was made from
JAX_MODULES = ("jax", "jaxlib", "flax", "summersph_tpu")


def load(kind: str, name: str) -> dict:
    """`<kind>/<name>.json` under the benchmark's directory."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"sphbench: no {kind[:-1]} {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str):
    """(workload, configuration, traffic) of the cell `name`."""
    wl = load("workloads", name)
    return wl, load("configs", wl["config"]), load("traffic", wl["traffic"])


def readers(workload: str) -> list:
    """The per-layer metric modules that list `workload`, by name."""
    out = []
    for path in sorted((HERE / "metrics").glob("[!_]*.py")):
        mod = importlib.import_module(f"sphbench.metrics.{path.stem}")
        if workload in getattr(mod, "WORKLOADS", ()):
            out.append(mod)
    return out


def configure(conf: dict, n=None):
    """(sim fields, ic parameters, particle count) of a configuration; with
    `n` its rehearsal form at n particles: the `rehearsal` block's fields,
    and its length fields scaled by (N / n)^(1/3), as the configuration's
    own h0 rule scales them."""
    sim, ic = dict(conf["sim"]), dict(conf["ic"])
    if n is None:
        return sim, ic, conf["n"]
    reh = conf["rehearsal"]
    sim.update(reh.get("sim", {}))
    scale = (conf["n"] / n) ** (1.0 / 3.0)
    for field in reh["length_fields"]:
        block, key = field.split(".")
        d = sim if block == "sim" else ic
        d[key] = d[key] * scale
    return sim, ic, n


def jax_modules() -> list:
    """The names of `JAX_MODULES` that `sys.modules` holds, compared by
    whole top-level name (`summersph_tpu_torch` is not `summersph_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_MODULES))


def program():
    """The program's modules, by their last dotted name."""
    ns = types.SimpleNamespace(pkg=importlib.import_module(PROGRAM))
    for m in PROGRAM_MODULES:
        setattr(ns, m.split(".")[-1], importlib.import_module(
            f"{PROGRAM}.{m}"))
    return ns


def card_report() -> str:
    """The card's name, power limit, SM clock and power draw."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def p90(values):
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Cell:
    """One cell, ready to run: its files, the program, its SimConfig.
    `device` and `n` exist for the CPU self-check and the tests: another
    device than the card runs the kernels' plain versions, and `n` the
    configuration's rehearsal form at n particles."""

    def __init__(self, workload: str, device="cuda", n=None):
        import torch

        self.torch = torch
        self.name = workload
        self.wl, self.conf, self.traffic = cell(workload)
        self.device = device
        self.on_card = torch.device(device).type == "cuda"
        self.prog = program()
        self.sim, self.ic, self.n = configure(self.conf, n)
        self.cfg = self.prog.config.SimConfig(**self.sim)
        self.spb = int(self.traffic["steps_per_sync"])
        self.var_h = self.sim["fixed_h"] is None

    def start(self, seed: int):
        """Set-up: the initial state from `seed`, primed and warmed up, the
        window's own bookkeeping (`_tally`) and the memory its sample holds
        among what is warmed up."""
        from sphbench import ics

        torch = self.torch
        state = ics.program_state(self.prog.pkg, self.cfg, self.ic, self.n,
                                  seed, self.device)
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state = self.prog.integrate.prime(state, self.cfg)
        dev = state.stats.device
        fields = self.prog.state.STATS_FIELDS
        self._slots = torch.tensor([fields.index(f) for f in FAULT_COUNTERS],
                                   device=dev)
        self._bad = torch.zeros((), dtype=torch.int64, device=dev)
        # hold as many states as the window's sample can, so that the
        # caching allocator has grown to the window's footprint
        held = collections.deque(
            maxlen=2 * int(self.traffic["check_segments"]))
        for _ in range(int(self.traffic["warmup_segments"])):
            state = self.prog.integrate.run_steps(state, self.cfg, self.spb)
            float(state.t)
            self._tally(state)
            held.append(state)
        held.clear()
        self._bad.zero_()
        return state

    def _tally(self, state):
        """Count on the card, with no host read, a segment whose health
        counters report a fault."""
        self._bad += (self.torch.amax(state.stats.index_select(
            0, self._slots)) > 0)

    def window(self, state, seed: int, seconds=None, segments=None,
               k_trace: int = 0):
        """The timed loop, for `seconds` or `segments`; the first `k_trace`
        segments under torch.profiler (the card's activity only).  Returns
        a namespace of what it saw, with `kept`, the seeded reservoir of
        (segment, S_in, S_out), and with `k_trace` the two ends of the
        traced span: `traced_in`, the first traced segment's input state,
        and `traced_out`, the output of segment `k_trace` (of the last
        segment if the window ends first).  They are references, no
        copies: a state is never written after it is made, as `kept`
        relies on too.  Without `k_trace` both are None."""
        torch = self.torch
        run_steps = self.prog.integrate.run_steps
        w = types.SimpleNamespace(n_live0=int(state.particles.n_alive),
                                  t0=float(state.t), seg_ms=[], kept=[],
                                  prof=None, traced_in=None, traced_out=None)
        rng = random.Random(seed)
        m_check = int(self.traffic["check_segments"])
        if k_trace:
            from torch.profiler import ProfilerActivity, profile
            w.traced_in = state
            w.prof = profile(activities=[ProfilerActivity.CUDA]
                             if self.on_card else [ProfilerActivity.CPU])
            w.prof.__enter__()
        w.setup_s = time.perf_counter() - T_START
        w0 = last = time.perf_counter()
        k = 0
        while True:
            s_in = state
            state = run_steps(state, self.cfg, self.spb)
            float(state.t)
            now = time.perf_counter()
            w.seg_ms.append((now - last) * 1e3)
            last = now
            self._tally(state)
            if len(w.kept) < m_check:
                w.kept.append((k, s_in, state))
            else:
                r = rng.randrange(k + 1)
                if r < m_check:
                    w.kept[r] = (k, s_in, state)
            k += 1
            if k == k_trace:
                w.prof.__exit__(None, None, None)
                w.traced_out = state
            if (segments is not None and k >= segments) or (
                    seconds is not None and now - w0 >= seconds):
                break
        if k < k_trace:
            w.prof.__exit__(None, None, None)
            w.traced_out = state
        w.traced = min(k, k_trace)
        w.window_s = last - w0
        w.segments = k
        w.steps = k * self.spb
        w.failed = int(self._bad)
        w.state = state
        w.n_live1 = int(state.particles.n_alive)
        w.t1 = float(state.t)
        w.mem_peak = (torch.cuda.max_memory_allocated() if self.on_card
                      else 0)
        return w

    def context(self, w, trace=None):
        """What the per-layer readers get (`context.Context`) after a
        window with `k_trace`: the states at the two ends of the traced
        span, the trace of that span, and its steps."""
        from sphbench.context import Context

        return Context(prog=self.prog, cfg=self.cfg, sim=self.sim,
                       state_in=w.traced_in, state=w.traced_out,
                       trace=trace, steps_traced=w.traced * self.spb)

    def samples(self, w):
        """The kept segments as the reference's float64 dicts, the
        program's states dropped: [(segment, S_in, S_out)]."""
        from sphbench import compare

        out = [(idx, compare.state_from_program(a),
                compare.state_from_program(b))
               for idx, a, b in sorted(w.kept, key=lambda x: x[0])]
        w.kept = []
        w.state = None
        gc.collect()
        if self.on_card:
            self.torch.cuda.empty_cache()
        return out

    def reference(self, d_in, dtype=None):
        """The plain reference's S_out from S_in, in float64 or, for the
        control, in `dtype`, cast back to float64."""
        from sphbench import reference

        st = dict(d_in)
        if dtype is not None:
            st = {k: v.to(dtype) if self.torch.is_tensor(v)
                  and v.is_floating_point() else v for k, v in st.items()}
        out = reference.run(st, self.sim, self.spb)
        return {k: v.double() if self.torch.is_tensor(v)
                and v.is_floating_point() else v for k, v in out.items()}

    def compare(self, d_in, d_out, d_ref):
        from sphbench import compare

        return compare.numbers(d_in, d_out, d_ref, self.var_h)


def main(argv=None, device="cuda", n=None) -> int:
    """One run (see the module docstring)."""
    args = parse(argv)
    wl = load("workloads", args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(CACHE_DIR / sub))
    import torch

    from sphbench import compare
    from sphbench.trace import Trace

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < wl["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sphbench: {args.workload} needs {wl['chips']} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 2
    c = Cell(args.workload, device, n)
    state = c.start(args.seed)
    k_trace = int(c.traffic["trace_segments"]) if args.trace else 0
    w = c.window(state, args.seed, seconds=args.seconds, k_trace=k_trace)
    state = None

    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if c.on_card else device,
                   "kind": (torch.cuda.get_device_name(0) if c.on_card
                            else device),
                   "count": wl["chips"] if c.on_card else 0,
                   "memory_peak_bytes": int(w.mem_peak)}
    if not args.trace:
        live = 0.5 * (w.n_live0 + w.n_live1)
        metrics = {
            "particle_steps_per_s": {"value": live * w.steps / w.window_s,
                                     "unit": "particle-steps/s"},
            "sim_yr_per_s": {"value": (w.t1 - w.t0) / w.window_s,
                             "unit": "yr/s"},
            "segment_ms_p90": {"value": p90(w.seg_ms), "unit": "ms"},
            "setup_s": {"value": w.setup_s, "unit": "s"},
        }
    else:
        tr = None
        if c.on_card:
            try:
                tr = Trace(w.prof.events())
            except ValueError as e:
                print(f"sphbench: trace unread: {e}", file=sys.stderr)
        ctx = c.context(w, tr)
        for mod in readers(args.workload):
            v = mod.read(ctx)
            if v is not None:
                metrics[mod.NAME] = {"value": float(v), "unit": mod.UNIT}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(10),
                         "idle_gaps": tr.top_gaps(10)}
        ctx = tr = w.traced_in = w.traced_out = None
    w.prof = None
    print(f"card: {card_report() if c.on_card else device}", flush=True)
    print(f"window: {w.segments} segments of {c.spb} steps in "
          f"{w.window_s:.6f} s, t {w.t0:.9g} -> {w.t1:.9g} yr (mean dt "
          f"{(w.t1 - w.t0) / max(w.steps, 1):.6g}), live {w.n_live0} -> "
          f"{w.n_live1}, segment ms median {statistics.median(w.seg_ms):.4f}"
          f" max {max(w.seg_ms):.4f}, failed {w.failed}, set-up "
          f"{w.setup_s:.3f} s, memory peak {w.mem_peak} bytes", flush=True)

    # ------------------------------------------------ correct
    t_ref = time.perf_counter()
    readings = []
    for idx, d_in, d_out in c.samples(w):
        nums = c.compare(d_in, d_out, c.reference(d_in))
        readings.append(nums)
        print(f"segment {idx}: " + ", ".join(
            f"{key} {v:.6g}" for key, v in sorted(nums.items())), flush=True)
    correct, lines = compare.judge(compare.worst(readings), wl["limits"])
    print(f"reference: {len(readings)} segments in "
          f"{time.perf_counter() - t_ref:.3f} s", flush=True)
    found = jax_modules()
    if found:
        print(f"sphbench: no result, the run holds {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    for key, v, lim, good in lines:
        print(f"check {key}: {v!r} limit {lim!r} {'ok' if good else 'FAIL'}",
              file=sys.stderr, flush=True)
    result = {"correct": bool(correct and readings), "attempted": w.segments,
              "failed": w.failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {
        key: {"value": v if v is not None and math.isfinite(v) else None,
              "limit": lim} for key, v, lim, _ in lines}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
