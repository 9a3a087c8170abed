"""The evidence runs of graded configurations 2-4 in the port
(`summersph_tpu_torch/tools/evidence.py`) against `scripts/evidence_runs.py`:
each builder's config and IC arguments field for field, the ICs per field,
the README's numbers from the committed JAX ledgers, the figures drawn
from a run's files, and the missing card.  The JAX run of two segments
against the port's is in test_torch_evidence_disc100.py and
test_torch_evidence_varh.py.

The module's top level imports no JAX: the script is imported inside the
tests, with EV_OUT pointed at the test's directory.
"""

import dataclasses
import importlib
import os
import re
import sys

import numpy as np
import pytest
import torch

from summersph_tpu_torch.state import to_numpy
from summersph_tpu_torch.tools import config5, evidence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "evidence_runs.py")
IC_FUNCTION = {"ring": "ring_ic", "disc100": "disc_ic", "varh": "disc_ic"}


class _Built(Exception):
    def __init__(self, kw):
        self.kw = kw


def _caught(*args, **kw):
    raise _Built(kw)


def script(monkeypatch, tmp_path):
    """scripts/evidence_runs.py imported with EV_OUT = tmp_path (it reads
    it when imported), dropped from sys.modules after."""
    monkeypatch.setenv("EV_OUT", str(tmp_path))
    monkeypatch.syspath_prepend(os.path.dirname(SCRIPT))
    sys.modules.pop("evidence_runs", None)
    try:
        return importlib.import_module("evidence_runs")
    finally:
        sys.modules.pop("evidence_runs", None)


def built_arguments(monkeypatch, tmp_path, name, smoke):
    """(ours, theirs): the keyword arguments each builder hands to its IC
    function, caught there; no ICs are made."""
    mod = script(monkeypatch, tmp_path)
    fn = IC_FUNCTION[name]
    monkeypatch.setattr(mod, fn, _caught)
    with pytest.raises(_Built) as theirs:
        mod.BUILDERS[name](smoke)
    monkeypatch.setattr(evidence, fn, _caught)
    with pytest.raises(_Built) as ours:
        evidence.BUILDERS[name](smoke, device="cpu")
    return ours.value.kw, theirs.value.kw


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ["ring", "disc100", "varh"])
def test_builder_matches_script(monkeypatch, tmp_path, name, smoke):
    """The SimConfig and the IC arguments of each builder equal the
    script's, and the builders are the script's BUILDERS."""
    ours, theirs = built_arguments(monkeypatch, tmp_path, name, smoke)
    assert (dataclasses.asdict(ours.pop("cfg"))
            == dataclasses.asdict(theirs.pop("cfg")))
    assert ours.pop("device") == "cpu"
    assert ours == theirs
    assert sorted(evidence.BUILDERS) == sorted(
        script(monkeypatch, tmp_path).BUILDERS)


@pytest.mark.parametrize("name", ["ring", "disc100", "varh"])
def test_smoke_ics_equal_the_scripts(monkeypatch, tmp_path, name):
    """Each builder's ICs at the smoke N equal the script's builder's, per
    field, bit for bit (so in float64 too)."""
    from test_torch_config_state import jax_state_dict

    theirs = jax_state_dict(script(monkeypatch, tmp_path).BUILDERS[name](
        True)[0])
    ours = to_numpy(evidence.BUILDERS[name](True, device="cpu")[0])
    for group in ("particles", "sinks"):
        assert ours[group].keys() == theirs[group].keys()
        for field, a in theirs[group].items():
            np.testing.assert_array_equal(
                ours[group][field].astype(np.float64)
                if a.dtype.kind == "f" else ours[group][field],
                a.astype(np.float64) if a.dtype.kind == "f" else a,
                err_msg=f"{name} {group}.{field}")
    for field in ("t", "dt", "stats"):
        np.testing.assert_array_equal(ours[field], theirs[field])


def _readme_bullets(name):
    with open(os.path.join(ROOT, "docs", "results", name, "README.md")) as fh:
        return [line.rstrip("\n") for line in fh if line.startswith("- ")]


@pytest.mark.parametrize("name", ["ring", "disc100", "varh"])
def test_readme_numbers_from_the_jax_ledger(name):
    """`readme_numbers` on the committed JAX ledger and the t0 measures of
    the full-size ICs gives the JAX README's bullets: time reached and
    segments, accretion, L_z and its drift, the final n_gas, rho_max and
    h_min digit for digit; the mass ledger's end total digit for digit.
    Its t0 total and drift differ in the last digits: the JAX run summed
    its t0 masses in float32 on its device (10.000001 for varh), the port
    sums in float64 (ROADMAP C 3), so the drift is held to one float32
    ulp of the total beyond the README's printed digits."""
    from summersph_tpu_torch.diagnostics import measure

    state, _ = evidence.BUILDERS[name](False, device="cpu")
    d = measure(state)
    d0 = {k: float(d[k]) for k in ("n_gas", "mass_gas", "mass_sinks")}
    led = config5.read_ledger(os.path.join(ROOT, "docs", "results", name,
                                           "ledger.csv"))
    num = evidence.readme_numbers(led, d0)
    ours = evidence.readme_lines(num)
    theirs = _readme_bullets(name)[1:6]
    assert [ours[i] for i in (0, 2, 3, 4)] == [theirs[i] for i in (0, 2, 3, 4)]
    mass = re.match(r"- gas\+sink mass ledger: ([\d.]+) -> ([\d.]+) M_sun "
                    r"\(drift ([\d.e+-]+);", theirs[1])
    m0, m1, drift = (float(g) for g in mass.groups())
    assert f"{num['m1']:.6f}" == mass.group(2)
    ulp = float(np.spacing(np.float32(num["m0"])))
    assert abs(num["m0"] - m0) <= 5e-7 + ulp
    half = 0.5 * 10.0 ** (np.floor(np.log10(drift)) - 2) if drift else 0.0
    assert abs(num["mass_drift"] - drift) <= half + ulp, (num, drift)


def _tiny_run(out, name, imaged):
    """A ledger of three rows and the panels a run writes, made up."""
    rows = [[0.5 * (i + 1), 1e-2, 100 - i, 1, 0.01, 1.0, 0.004, 1e-6,
             0.0, 0.0, 0.0, 0.44 - 1e-4 * i, 2e-6, 2.0, 0.3]
            for i in range(3)]
    with open(os.path.join(out, "ledger.csv"), "w") as fh:
        fh.write(",".join(config5.LEDGER_COLUMNS) + "\n")
        for r in rows:
            fh.write(",".join(str(x) for x in r) + "\n")
    rng = np.random.default_rng(0)
    panels = dict(name=name, smoke=False, device="cpu", n0=100, t_final=1.5,
                  profile_t=np.array([0.0, 1.0, 1.5]),
                  profile_r=np.tile(np.linspace(1, 40, 40), (3, 1)),
                  profile_sigma=rng.random((3, 40)),
                  seg_wall=np.full(3, 0.3), tested_per_row=np.full(3, 50.0))
    if name == "varh":
        panels.update(h_r=rng.random(100) * 50, h_h=rng.random(100) * 5)
    if imaged:
        for label in ("t0", "end"):
            panels.update({f"image_{label}": rng.random((12, 12)),
                           f"image_sinks_{label}": np.zeros((1, 2)),
                           f"image_time_{label}": 1.0})
        panels["image_xi"] = np.linspace(-110, 110, 12)
    np.savez_compressed(os.path.join(out, "panels.npz"), **panels)


@pytest.mark.parametrize("name", ["ring", "varh"])
def test_render_draws_the_figures(tmp_path, name):
    """`render` (and `--render`) draws evolution.png and, where the panels
    hold the projections, density_t0.png and density_end.png."""
    pytest.importorskip("matplotlib")
    imaged = name in evidence.IMAGED
    _tiny_run(str(tmp_path), name, imaged)
    assert evidence.main(["--render", str(tmp_path)]) == 0
    want = ["evolution.png"] + (["density_t0.png", "density_end.png"]
                                if imaged else [])
    for png in want:
        assert (tmp_path / png).stat().st_size > 1000, png
    assert sorted(p.name for p in tmp_path.glob("*.png")) == sorted(want)


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """The default --device cuda raises where torch sees no card, before
    anything is built or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        evidence.main(["--config", "ring", "--out", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_smoke_run_writes_ledger_panels_and_readme(tmp_path):
    """`run_config` on the CPU at the ring's smoke N for two segments of
    two steps: a 15-column ledger of two rows, the panels (three
    profiles: t0, the first row past half of end_time, the end) and the
    README with the script's bullets; the ring's mass and count exact."""
    state, cfg, code = evidence.run_config(
        "ring", smoke=True, seg_steps=2, t_end=0.1, device="cpu",
        out_dir=str(tmp_path), max_segments=2)
    assert code == 0
    led = config5.read_ledger(str(tmp_path / "ledger.csv"))
    assert len(led["t"]) == 2 and list(led) == config5.LEDGER_COLUMNS
    assert np.all(led["n_gas"] == 512) and np.all(led["m_gas"] == 0.01)
    z = np.load(tmp_path / "panels.npz")
    assert z["profile_sigma"].shape == (3, evidence.PROFILE_BINS)
    assert z["seg_wall"].shape == z["tested_per_row"].shape == (2,)
    assert np.all(z["tested_per_row"] > 0)
    readme = (tmp_path / "README.md").read_text()
    assert "- N0 = 512 gas, ran t = 0 -> " in readme
    assert "(2 ledger segments)" in readme


def _script_row_code():
    """The script's statements from `d = measure(state)` to the ledger
    row's assignment in run_config's loop, from its source."""
    import ast

    with open(SCRIPT) as fh:
        src = fh.read()
    loop = next(node for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.While))
    body = loop.body
    first = next(i for i, st in enumerate(body)
                 if isinstance(st, ast.Assign)
                 and ast.unparse(st.targets[0]) == "d")
    last = next(i for i, st in enumerate(body)
                if isinstance(st, ast.Assign)
                and ast.unparse(st.targets[0]) == "row")
    return "\n".join(ast.unparse(st) for st in body[first:last + 1])


def two_segments_against_jax(monkeypatch, tmp_path, name, seg_steps=4):
    """Two segments of `seg_steps` steps of a builder's smoke config, in
    float64 on the CPU: the port through `evidence.run` (its plain
    versions) and the JAX package on its XLA sorted engine
    (use_pallas=False, windows of 8 blocks: every candidate at N = 1024;
    the XLA FFT on both sides), from the ICs of the script's arguments.
    The ledger rows (but the wall column) agree with the script's own rows
    of the JAX states, and the end states per pid, within rtol 1e-7
    (test_torch_collapse's 10-step tolerance; a momentum component within
    it of the momentum's largest), every stats slot equal."""
    import csv

    import summersph_tpu.integrate as jint
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.models.disc import disc_ic as jax_disc_ic
    from summersph_tpu_torch.config import SimConfig
    from summersph_tpu_torch.models.disc import disc_ic
    from test_torch_collapse import compare
    from test_torch_config_state import jax_state_dict

    mod = script(monkeypatch, tmp_path)
    _, kw = built_arguments(monkeypatch, tmp_path, name, True)
    cfg_kw = dataclasses.asdict(kw.pop("cfg"))
    cfg_kw.update(dtype="float64", use_pallas=False, window_blocks=8,
                  grav_window_blocks=8, grav_fft="xla")
    jcfg, cfg = JaxConfig(**cfg_kw), SimConfig(**cfg_kw)
    state, code = evidence.run(name, disc_ic(cfg=cfg, device="cpu", **kw)[0],
                               cfg, str(tmp_path / "port"), seg_steps,
                               max_segments=2, smoke=True)
    assert code == 0
    with open(tmp_path / "port" / "ledger.csv") as fh:
        ours = list(csv.reader(fh))
    js = jint.prime(jax_disc_ic(cfg=jcfg, **kw)[0], jcfg)
    theirs, row_code = [], _script_row_code()
    for _ in range(2):
        js = jint.run_steps(js, jcfg, seg_steps)
        ns = {"state": js, "measure": mod.measure, "jnp": mod.jnp, "np": np,
              "wall": 0.0}
        exec(row_code, ns)
        theirs.append([str(x) for x in ns["row"]])
    assert ours[0] == config5.LEDGER_COLUMNS and len(ours) == 3
    mom = [config5.LEDGER_COLUMNS.index(c) for c in ("px", "py", "pz")]
    for a, b in zip(ours[1:], theirs):
        a, b = np.array(a[:-1], dtype=float), np.array(b[:-1], dtype=float)
        # momentum within rtol of its vector's size: pz cancels to ~1e-20
        scale = np.abs(b)
        scale[mom] = np.abs(b[mom]).max()
        assert np.all(np.abs(a - b) <= 1e-7 * scale), (a, b)
    compare(state, jax_state_dict(js), 1e-7)
    return state


def test_config5_report_draws_the_evolution_figure(monkeypatch, tmp_path):
    """`tools.config5 --report` on a copy of the committed H100 ledger
    prints the summary and draws collapse_evolution.png beside it."""
    pytest.importorskip("matplotlib")
    import shutil

    shutil.copy(os.path.join(ROOT, "docs", "results", "collapse1m_h100",
                             "ledger.csv"), tmp_path / "ledger.csv")
    monkeypatch.setenv("C5_OUT", str(tmp_path))
    assert config5.main(["--report"]) == 0
    assert (tmp_path / "collapse_evolution.png").stat().st_size > 1000
