"""The port's benchmark (`summersph_tpu_torch/bench.py`, `python -m
summersph_tpu_torch bench`) against the root `bench.py`: the config of
every cell field for field, the timed path's state per pid, the JSON line
and the sweep's budget and failure rules.

The module's top level imports torch, numpy and the port only, so that
the `gpu` test collects on the card's machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_bench.py
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from summersph_tpu_torch import bench as tbench
from summersph_tpu_torch import cli as tcli
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.ops.sorted_grid import (PLANE_OFFSETS, SENTINEL_KEY,
                                                 sort_h_pad, sort_particles)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("BENCH_N", "BENCH_STEPS", "BENCH_GRAVITY", "BENCH_PALLAS",
         "BENCH_SWEEP", "BENCH_BUDGET_S", "BENCH_PM_GRID", "BENCH_WG",
         "BENCH_EXACT", "BENCH_FUSE", "BENCH_PM_EVERY")
KEYS = ["metric", "value", "unit", "vs_baseline", "platform", "utilization",
        "sweep"]
N = 2048
# the headline (pm_every from BENCH_PM_EVERY) and bench.py's sweep cells
CELLS = [(1048576, "none", None), *tbench.sweep_cells(1048576)]
ENVS = [{}, {"BENCH_PM_GRID": "128"}, {"BENCH_WG": "32"},
        {"BENCH_FUSE": "0"}, {"BENCH_EXACT": "1", "BENCH_PM_EVERY": "4"}]


@pytest.fixture
def env(monkeypatch):
    """No BENCH_* knob from outside; the test sets its own."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


class _Built(Exception):
    def __init__(self, cfg):
        self.cfg = cfg


def _jax_bench_cfg(monkeypatch, *args, **kw):
    """The SimConfig that the root bench.py's run_config builds, caught
    where it hands it to disc_ic (imported inside run_config)."""
    import importlib

    def caught(*a, cfg=None, **k):
        raise _Built(cfg)

    monkeypatch.syspath_prepend(ROOT)
    jbench = importlib.import_module("bench")
    with monkeypatch.context() as m:
        m.setattr("summersph_tpu.models.disc.disc_ic", caught)
        with pytest.raises(_Built) as got:
            jbench.run_config(*args, **kw)
    return got.value.cfg


@pytest.mark.parametrize("knobs", ENVS, ids=lambda e: ",".join(e) or "none")
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_config_matches_bench_py(env, cell, knobs):
    """bench_config equals bench.py's SimConfig field for field, for the
    headline and the four sweep cells, under the env knobs."""
    import dataclasses

    for k, v in knobs.items():
        env.setenv(k, v)
    n, gravity, pm_every = cell
    theirs = _jax_bench_cfg(env, n, 20, gravity, pm_every=pm_every)
    ours, h0 = tbench.bench_config(n, gravity, pm_every=pm_every)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert h0 == theirs.fixed_h


def test_timed_path_matches_jax(env):
    """The bench's state after prime + run_steps(2) + run_steps(2) (the
    warm-up and the timed run) at N = 2048, in float64, against the JAX
    package's on the same config, per pid.  JAX runs its XLA sorted engine
    with window_blocks 4, whose windows cover every candidate (stats slot
    0 stays 0).  Tolerances: tests/test_torch_integrate.py's for the same
    fields after 10 steps (rtol 1e-7 on pos, vel, u, rho, acc; 1e-12 on t
    and dt; stats and the sinks' alive, mass and radius equal)."""
    from summersph_tpu.integrate import prime as jprime
    from summersph_tpu.integrate import run_steps as jrun_steps
    from summersph_tpu.models.disc import disc_ic as jdisc_ic

    from test_torch_config_state import jax_state_dict

    cfg, h0 = tbench.bench_config(N)
    cfg = cfg.with_(dtype="float64")
    ours, wall = tbench.timed_steps(tbench.bench_disc(N, cfg, h0, "cpu"),
                                    cfg, 2)
    assert wall > 0.0
    jcfg = _jax_bench_cfg(env, N, 2, "none").with_(
        use_pallas=False, window_blocks=4, dtype="float64")
    js = jdisc_ic(n=N, r_max=100.0, m_star=5.0, h0=h0, rotation="keplerian",
                  cfg=jcfg, seed=0)[0]
    js = jrun_steps(jrun_steps(jprime(js, jcfg), jcfg, 2), jcfg, 2)

    ours, theirs = tstate.to_numpy(ours), jax_state_dict(js)
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-12)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    po, pt = ours["particles"], theirs["particles"]
    oo, ot = np.argsort(po["pid"]), np.argsort(pt["pid"])
    np.testing.assert_array_equal(po["pid"][oo], pt["pid"][ot])
    np.testing.assert_array_equal(po["alive"][oo], pt["alive"][ot])
    for name in ("pos", "vel", "u", "rho", "acc"):
        np.testing.assert_allclose(po[name][oo], pt[name][ot], rtol=1e-7,
                                   err_msg=name)
    for name in ("alive", "mass", "radius"):
        np.testing.assert_array_equal(ours["sinks"][name],
                                      theirs["sinks"][name], err_msg=name)


def _brute_candidates(state, cfg):
    """Candidates of every window group's 9 plane ranges, counted over
    the live keys one by one: keys in [first key + offset - 1, last key +
    offset + 1] of the group."""
    _, grid = sort_particles(state.particles, cfg, h_pad=sort_h_pad(cfg))
    key = grid.key.numpy().astype(np.int64)
    live = key[key != SENTINEL_KEY]
    wg = cfg.window_group
    total = 0
    for g in range(key.shape[0] // wg):
        lo, hi = key[g * wg], key[(g + 1) * wg - 1]
        for off in PLANE_OFFSETS:
            total += int(np.sum((live >= lo + off - 1)
                                & (live <= hi + off + 1)))
    return total * wg


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_cli_prints_bench_py_line(env, capsys):
    """`bench --n 2048 --steps 2 --device cpu` with BENCH_SWEEP=0: one
    line with bench.py's keys in its order and metric string, platform
    'cpu', and the candidates per row of the end state's windows."""
    env.setenv("BENCH_SWEEP", "0")
    seen, count = [], tbench.pair_candidates

    def spy(state, cfg):
        seen.append((state, cfg))
        return count(state, cfg)

    env.setattr(tbench, "pair_candidates", spy)
    assert tcli.main(["bench", "--n", str(N), "--steps", "2", "--device",
                      "cpu"]) == 0
    [line] = _lines(capsys)
    assert list(line) == KEYS
    assert line["metric"] == ("particle-steps/sec (Keplerian disc, N=2048, "
                              "gravity=none, single chip)")
    assert line["unit"] == "particle-steps/sec"
    assert line["platform"] == "cpu" and line["sweep"] == {}
    assert math.isfinite(line["value"]) and line["value"] > 0.0
    assert line["vs_baseline"] == line["value"] / 1e8
    [(state, cfg)] = seen
    alive = int(state.particles.n_alive)
    util = line["utilization"]
    assert util["pair_candidates_per_row"] == \
        _brute_candidates(state, cfg) / alive
    assert util["pair_candidate_rate_per_s"] > 0.0


def test_sweep_skips_past_the_budget(env, capsys):
    """With the budget spent, the first sweep cell runs all the same and
    the other three are skipped; the line is printed after each cell."""
    env.setenv("BENCH_PM_GRID", "32")   # a 512^3 mesh is no CPU job
    env.setenv("BENCH_BUDGET_S", "0")
    assert tbench.main(["--n", str(N), "--steps", "2", "--device",
                        "cpu"]) == 0
    lines = _lines(capsys)
    assert [len(line["sweep"]) for line in lines] == [0, 1, 2, 3, 4]
    sweep = lines[-1]["sweep"]
    assert list(sweep) == ["N=2048,gravity=pm,pm_every=8",
                           "N=2048,gravity=pm,pm_every=4",
                           "N=2048,gravity=pm", "N=131072,gravity=none"]
    first = sweep.pop("N=2048,gravity=pm,pm_every=8")
    assert isinstance(first, float) and first > 0.0
    assert set(sweep.values()) == {"skipped: wall budget"}


def test_a_failed_cell_is_recorded_and_fails_the_run(env, capsys):
    """A sweep cell that raises is recorded as 'failed: <error>', the
    other cells still run, and the exit code is 1."""
    def fake(n, steps, gravity, use_pallas=True, grav_grid=None,
             pm_every=None, device="cuda"):
        if pm_every == 4:
            raise RuntimeError("no mesh today")
        return float(n), {}

    env.setattr(tbench, "run_config", fake)
    assert tbench.bench(n=N, steps=2, device="cpu") == 1
    sweep = _lines(capsys)[-1]["sweep"]
    assert sweep == {"N=2048,gravity=pm,pm_every=8": 2048.0,
                     "N=2048,gravity=pm,pm_every=4": "failed: no mesh today",
                     "N=2048,gravity=pm": 2048.0,
                     "N=131072,gravity=none": 131072.0}


def test_no_card_raises_unless_the_cpu_is_asked_for(env, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for call in (lambda: tcli.main(["bench", "--n", "16"]),
                 lambda: tbench.main(["--n", "16"])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    assert capsys.readouterr().out == ""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_run_config_on_the_card(cuda_device):
    """The gravity='none' cell at N = 131,072 on the card: a finite
    positive rate, with both fixed-h kernels launched once a step plus
    once for prime."""
    from summersph_tpu_torch.ops import cuda_pairs

    before = (cuda_pairs.density_sums.launches,
              cuda_pairs.force_sums.launches)
    rate, util = tbench.run_config(131072, 4, "none", device=cuda_device)
    after = (cuda_pairs.density_sums.launches,
             cuda_pairs.force_sums.launches)
    assert math.isfinite(rate) and rate > 0.0
    assert util["pair_candidates_per_row"] > 0.0
    assert [a - b for a, b in zip(after, before)] == [9, 9]
