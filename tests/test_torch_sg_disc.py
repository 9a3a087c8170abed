"""The Keplerian disc with its own gravity, the benchmark's configuration
`kepler_disc_sg` (`sphbench/configs/kepler_disc_sg.json`: the disc with
TreePM self-gravity, the short range fused into the force kernel and the
far field solved every step), on the CPU at its rehearsal size (N =
4096, grid 64) with the kernels' plain versions:

* the configuration is the disc's but for the fields of self-gravity;
* one segment of its cell, `kepler_disc_sg.n1m.pm1`, against the plain
  reference within the cell's limits, and the reference computed in
  bfloat16 beyond them;
* the fused step against the separate short-range step on the same
  state, and a planted zero of the fused gravity sums caught by the same
  comparison;
* r_cut against the SPH cell 2 h at the full size (grid 256), the
  rehearsal size and grid 32, and the fused sort's cell, max(2 h, r_cut);
* beyond 2 h (grid 32), a fused global step and a fused block step that
  report no dropped row and equal the separate short range;
* the four child spans of a solve under a CPU profiler, and the profiled
  step equal bit for bit to the unprofiled one.

No JAX: the benchmark's files import none."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import summersph_tpu_torch as pkg  # noqa: E402
from sphbench import compare, ics, reference, run  # noqa: E402
from summersph_tpu_torch import tracing  # noqa: E402
from summersph_tpu_torch.blockstep import step_binned  # noqa: E402
from summersph_tpu_torch.config import SimConfig  # noqa: E402
from summersph_tpu_torch.integrate import (  # noqa: E402
    force_eval, prime, run_steps)
from summersph_tpu_torch.ops import cuda_pairs  # noqa: E402
from summersph_tpu_torch.ops.gravity import far_field_plan  # noqa: E402
from summersph_tpu_torch.ops.sorted_grid import sort_particles  # noqa: E402
from summersph_tpu_torch.state import STATS_FIELDS  # noqa: E402

SEED = 2147483659
REHEARSAL_N = 4096
CONFIG = "kepler_disc_sg"
CELL = "kepler_disc_sg.n1m.pm1"
# the disc's fields that self-gravity changes: TreePM at grid 256 (64 at
# the rehearsal size), the short range fused, the far field every step
SELF_GRAVITY = dict(gravity="pm", grav_grid=256, grav_fuse_short=True,
                    pm_every=1)
PM_CHILDREN = ["pm_deposit", "pm_poisson", "pm_gradient", "pm_gather"]
# The fused and the separate short range sum the same pairs in another
# order (the SPH windows against the r_cut-wide gravity sort) and add the
# three parts of acc in another order, each rounding at float32's 2^-24
# (6e-8) of its size: 1.8e-8 of max|acc| apart on the CPU.  A tolerance
# of 16 ulps of max|acc|, 1e-6, passes that; the short range is 2.5e-4 of
# max|acc| (the sink's pull on the innermost gas sets the max), so its
# absence reads 250 times the tolerance.
ACC_TOL = 1.0e-6


def disc_sg(n=REHEARSAL_N, grid=None):
    """(SimConfig fields, ic parameters, n) of the configuration, its
    rehearsal form at `n` particles (`n` None: the full size), with the
    mesh at `grid` where given."""
    sim, ic, n = run.configure(run.load("configs", CONFIG), n)
    if grid is not None:
        sim["grav_grid"] = grid
    return sim, ic, n


def disc_sg_state(grid=None):
    """(cfg, the primed state at t = 0) at the rehearsal size."""
    sim, ic, n = disc_sg(grid=grid)
    cfg = SimConfig(**sim)
    return cfg, prime(ics.program_state(pkg, cfg, ic, n, SEED, "cpu"), cfg)


@pytest.fixture(scope="module")
def primed():
    return disc_sg_state()


def test_configuration_is_the_disc_with_self_gravity():
    """The disc's fields but the four of self-gravity (the disc already
    holds grid 256 and pm_every 1, unused without gravity)."""
    disc = run.load("configs", "kepler_disc")
    sg = run.load("configs", CONFIG)
    assert sg["name"] == CONFIG and sg["reduced"] == []
    assert (sg["n"], sg["ic"]) == (disc["n"], disc["ic"])
    assert set(sg["sim"]) == set(disc["sim"])
    assert {k for k in sg["sim"] if sg["sim"][k] != disc["sim"][k]} \
        == {"gravity", "grav_fuse_short"}
    assert {k: sg["sim"][k] for k in SELF_GRAVITY} == SELF_GRAVITY
    assert sg["rehearsal"] == dict(disc["rehearsal"],
                                   sim={"grav_grid": 64})
    wl = run.load("workloads", CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (CONFIG, "seg8", 1)


@pytest.fixture(scope="module")
def rehearsal_segment():
    """(the cell at the rehearsal size, one segment's input and output, the
    plain reference's output from the same input)."""
    c = run.Cell(CELL, device="cpu", n=REHEARSAL_N)
    w = c.window(c.start(SEED), SEED, segments=1)
    (_, d_in, d_out), = c.samples(w)
    assert int(w.failed) == 0
    return c, d_in, d_out, c.reference(d_in)


def test_rehearsal_segment_within_the_cells_limits(rehearsal_segment):
    c, d_in, d_out, ref = rehearsal_segment
    ok, lines = compare.judge(c.compare(d_in, d_out, ref), c.wl["limits"])
    assert ok, lines


def test_rehearsal_control_fails_the_cells_limits(rehearsal_segment):
    c, d_in, _, ref = rehearsal_segment
    ctrl = c.compare(d_in, c.reference(d_in, torch.bfloat16), ref)
    ok, lines = compare.judge(ctrl, c.wl["limits"])
    assert not ok, lines


def _acc_gap(state, cfg):
    """max |acc_fused - acc_separate| / max |acc_separate| of one force
    evaluation on `state`, rows in the same SPH sort order."""
    fused = force_eval(state.particles, state.sinks, cfg)
    sep = force_eval(state.particles, state.sinks,
                     cfg.with_(grav_fuse_short=False))
    assert int(fused[2][1]) == 0 and int(sep[2][1]) == 0
    assert torch.equal(fused[0].pid, sep[0].pid)
    a, b = fused[0].acc.double(), sep[0].acc.double()
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def test_fused_step_matches_the_separate_short_range(primed):
    cfg, state = primed
    assert cfg.grav_fuse_short
    assert _acc_gap(state, cfg) < ACC_TOL


def test_planted_zero_of_the_gravity_sums_is_caught(primed, monkeypatch):
    cfg, state = primed
    plain = cuda_pairs.force_sums_plain

    def zeroed(*args, **kwargs):
        out = plain(*args, **kwargs)
        if len(out) == 5:      # the separate step's force sums
            return out
        return out[:5] + (tuple(torch.zeros_like(g) for g in out[5]),)

    monkeypatch.setattr(cuda_pairs, "force_sums_plain", zeroed)
    assert _acc_gap(state, cfg) > ACC_TOL


@pytest.mark.parametrize("form,fits", [("full", True), ("rehearsal", True),
                                       ("grid 32", False)])
def test_rcut_against_the_sort_cell(form, fits):
    """r_cut = rcut_rs x r_s against the SPH cell 2 h (fixed h: no
    headroom), on the ball drawn at t = 0: within it with 8% of margin at
    the full size and inside at the rehearsal size, beyond it at grid 32.
    At the rehearsal size the fused sort's cell is max(2 h, r_cut)."""
    n, grid = {"full": (None, 256), "rehearsal": (REHEARSAL_N, 64),
               "grid 32": (REHEARSAL_N, 32)}[form]
    sim, ic, n = disc_sg(n, grid)
    a = ics.sample(ic, n, SEED, "cpu")
    st = {"pos": a["pos"], "alive": torch.ones(n, dtype=torch.bool),
          "h": torch.full((n,), sim["fixed_h"], dtype=torch.float64)}
    r_cut = reference.rcut_rs(sim) * reference.pm_geometry(st, sim)[2]
    cell_sph = reference.sph_grid(st, sim)[1]
    assert float(cell_sph) == pytest.approx(2.0 * sim["fixed_h"])
    assert (float(r_cut) <= float(cell_sph)) == fits
    if form == "full":
        assert float(r_cut) / float(cell_sph) < 0.93
        return
    cfg = SimConfig(**sim)
    p = ics.program_state(pkg, cfg, ic, n, SEED, "cpu").particles
    plan = far_field_plan(p, cfg)
    grid_p = sort_particles(p, cfg, min_cell=plan.min_cell)[1]
    assert float(plan.split[1]) == pytest.approx(float(r_cut), rel=1e-6)
    assert float(grid_p.cell_size) == pytest.approx(
        max(float(r_cut), 2.0 * sim["fixed_h"]), rel=1e-6)


@pytest.mark.parametrize("engine", ["global step", "block step"])
def test_fused_step_beyond_2h_matches_the_separate_short_range(engine):
    """At grid 32 r_cut exceeds 2 h (test_rcut_against_the_sort_cell): a
    fused step sorts on a cell of r_cut, counts no fault, and its acc
    equals the separate short range's within ACC_TOL of max|acc|; the
    positions, one drift from the same state, are equal."""
    cfg, state = disc_sg_state(grid=32)
    if engine == "block step":
        cfg = cfg.with_(dt_bins=2)
    out = {}
    for fuse in (True, False):
        c = cfg.with_(grav_fuse_short=fuse)
        s = (step_binned(state, c) if engine == "block step"
             else run_steps(state, c, 1))
        assert s.stats.tolist() == [0] * len(STATS_FIELDS)
        order = torch.argsort(s.particles.pid)
        out[fuse] = {f: getattr(s.particles, f)[order].double()
                     for f in ("acc", "pos")}
    a, b = out[True]["acc"], out[False]["acc"]
    assert float(torch.max(torch.abs(a - b))
                 / torch.max(torch.abs(b))) < ACC_TOL
    assert torch.equal(out[True]["pos"], out[False]["pos"])


def test_solve_has_four_child_spans_and_changes_no_bit(primed):
    cfg, state = primed
    plain = run_steps(state, cfg, 1)
    tracing.collect()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run_steps(state, cfg, 1)
    spans = tracing.collect()["spans"]
    (k,) = [i for i, sp in enumerate(spans) if sp[0] == "pm_long_range"]
    kids = [sp for sp in spans if sp[1] == k]
    assert [sp[0] for sp in kids] == PM_CHILDREN
    assert all(spans[k][3] <= sp[3] <= sp[4] <= spans[k][4] for sp in kids)
    assert not [sp for sp in spans if sp[0] in PM_CHILDREN and sp[1] != k]
    for part in ("particles", "sinks"):
        a, b = getattr(plain, part), getattr(traced, part)
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x, y), f"{part}.{f}"
    for f in ("t", "dt", "stats"):
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
