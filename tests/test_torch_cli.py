"""The port's command line, tools and small models against the JAX
package's: the argparse flags of `run`, `resume`, `make-ics` and `image`,
the files `run` writes, `resume`'s config, the `make-ics` bytes, the
density grid, the Sod and ring models and the Sod L2 on the sorted engine.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import summersph_tpu.cli as jcli
import summersph_tpu_torch.cli as tcli
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.io import load_npz_with_config

from test_torch_config_state import jax_state_dict

SUBCOMMANDS = ("run", "resume", "make-ics", "image")
N_IC, H_IC = 512, 15.0     # ~14 neighbours a particle in the r=100 disc


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(main, monkeypatch):
    """The top-level parser `main` builds, caught at its parse_args."""
    def catch(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as got:
            main(["run"])
    return got.value.parser


def _actions(sub):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.required, a.nargs, type(a).__name__)
            for a in sub._actions if not isinstance(a, argparse._HelpAction)}


def _subparsers(parser):
    [action] = [a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)]
    return action.choices


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_flags_match_the_jax_cli(cmd, monkeypatch):
    theirs = _subparsers(_parser(jcli.main, monkeypatch))
    ours = _subparsers(_parser(tcli.main, monkeypatch))
    ours_cmd = _actions(ours[cmd])
    device = ours_cmd.pop("device")
    assert device[:2] == (("--device",), "cuda")
    assert ours_cmd == _actions(theirs[cmd])
    # bench waits for a benchmark of the port: the one subcommand left out
    assert set(theirs) - set(ours) == {"bench"}
    assert set(ours) == set(SUBCOMMANDS)


def test_no_card_raises_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["make-ics", "sod", "--out", str(tmp_path / "s.txt"),
                   "--n", "16"])
    assert not (tmp_path / "s.txt").exists()


def _rows(path):
    rows = np.loadtxt(path, skiprows=1, ndmin=2)
    return rows[np.lexsort(rows.T[::-1])]


def _hold_f32(ours, theirs, err_msg=""):
    """float32 results of two engines: rtol 1e-5, atol 1e-5 x max|column|."""
    ours, theirs = ours.reshape(len(ours), -1), theirs.reshape(len(theirs), -1)
    for c in range(theirs.shape[1]):
        np.testing.assert_allclose(
            ours[:, c], theirs[:, c], rtol=1e-5,
            atol=1e-5 * np.abs(theirs[:, c]).max(), err_msg=f"{err_msg} {c}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`make-ics disc` by the port; `run` on that file by both CLIs with
    the defaults (neighbor_mode 'grid', float32) and a fixed h that gives
    every particle neighbours; then `resume` by the port."""
    root = tmp_path_factory.mktemp("cli")
    ic = str(root / "disc.txt")
    assert tcli.main(["make-ics", "disc", "--out", ic, "--n", str(N_IC),
                      "--seed", "3", "--device", "cpu"]) == 0
    flags = ["--ic", ic, "--fixed-h", str(H_IC), "--end-time", "0.02",
             "--n-saves", "2", "--set", "dt_init=1e-4", "--set",
             "dt_max=2e-3"]
    assert jcli.main(["run", *flags, "--out", str(root / "jax")]) == 0
    assert tcli.main(["run", *flags, "--out", str(root / "port"),
                      "--device", "cpu"]) == 0
    first = load_npz_with_config(root / "port" / "checkpoint.npz",
                                 device="cpu")
    assert tcli.main(["resume", str(root / "port" / "checkpoint.npz"),
                      "--out", str(root / "resumed"), "--end-time", "0.05",
                      "--n-saves", "1", "--device", "cpu"]) == 0
    return root, first


def test_run_writes_the_files_jax_writes(runs):
    from summersph_tpu.io.checkpoint import load_npz_with_config as jload

    root = runs[0]
    names = sorted(f.name for f in (root / "port").iterdir())
    assert names == sorted(f.name for f in (root / "jax").iterdir())
    assert names == ["checkpoint.npz", "save0.txt", "save1.txt"]
    for name in names[1:]:
        ours, theirs = _rows(root / "port" / name), _rows(root / "jax" / name)
        assert ours.shape == theirs.shape == (N_IC + 1, 9)
        _hold_f32(ours, theirs, name)
    st, cfg = load_npz_with_config(root / "port" / "checkpoint.npz",
                                   device="cpu")
    jst, jcfg = jload(root / "jax" / "checkpoint.npz")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.neighbor_mode == "grid" and cfg.fixed_h == H_IC
    ours, theirs = tstate.to_numpy(st), jax_state_dict(jst)
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-6)
    po, pt = ours["particles"], theirs["particles"]
    oo, ot = np.argsort(po["pid"]), np.argsort(pt["pid"])
    for name in ("pos", "vel", "u", "rho", "acc"):
        _hold_f32(po[name][oo], pt[name][ot], name)


def test_resume_overrides_only_the_flags_given(runs):
    root, (st0, cfg0) = runs
    st, cfg = load_npz_with_config(root / "resumed" / "checkpoint.npz",
                                   device="cpu")
    assert cfg == cfg0.with_(end_time=0.05, n_saves=1)
    assert float(st.t) >= 0.05 > float(st0.t)
    assert sorted(f.name for f in (root / "resumed").iterdir()) == [
        "checkpoint.npz", "save0.txt"]


@pytest.mark.parametrize("kind", ["disc", "rigid-sphere", "collapse", "ring",
                                  "sod"])
def test_make_ics_bytes_match_jax(tmp_path, kind):
    # sod_ic takes no seed, in both packages: `--seed` raises TypeError there
    seed = [] if kind == "sod" else ["--seed", "5"]
    jcli.main(["make-ics", kind, "--out", str(tmp_path / "jax.txt"),
               "--n", "64", *seed])
    tcli.main(["make-ics", kind, "--out", str(tmp_path / "port.txt"),
               "--n", "64", *seed, "--device", "cpu"])
    ours = (tmp_path / "port.txt").read_bytes()
    assert ours == (tmp_path / "jax.txt").read_bytes()
    assert len(ours.splitlines()) == 1 + 64 + 1


def test_density_grid_matches_jax():
    from summersph_tpu.tools.density_image import density_grid as jgrid
    from summersph_tpu_torch.tools.density_image import density_grid

    rng = np.random.default_rng(1)
    pos = rng.uniform(-40.0, 40.0, (300, 3))
    mass = rng.random(300) + 0.5
    h = rng.random(300) * 5.0 + 8.0
    ours, xi = density_grid(pos, mass, h, resolution=16, box=50.0,
                            device="cpu")
    theirs, jxi = jgrid(pos, mass, h, resolution=16, box=50.0)
    np.testing.assert_array_equal(xi, jxi)
    assert ours.shape == (16, 16, 16) and ours.max() > 0
    np.testing.assert_allclose(ours, theirs, rtol=1e-5,
                               atol=1e-5 * theirs.max())


def test_projected_density_from_snapshot_matches_jax(runs):
    from summersph_tpu.tools.density_image import \
        projected_density_from_snapshot as jproj
    from summersph_tpu_torch.tools.density_image import \
        projected_density_from_snapshot

    snap = runs[0] / "port" / "save1.txt"
    ours = projected_density_from_snapshot(snap, resolution=16, device="cpu")
    theirs = jproj(snap, resolution=16)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=1e-5,
                               atol=1e-5 * theirs[0].max())
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[2], theirs[2])


def test_sod_and_ring_models_match_jax():
    from summersph_tpu.models import ring as jring
    from summersph_tpu.models import sod as jsod
    from summersph_tpu_torch.models import ring, sod

    x = np.linspace(-0.7, 0.7, 301)
    for t in (0.0, 0.1, 0.2):
        for ours, theirs in zip(sod.sod_exact(x, t), jsod.sod_exact(x, t)):
            np.testing.assert_array_equal(ours, theirs)
    assert dataclasses.asdict(sod.sod_config(400, end_time=0.1)) == \
        dataclasses.asdict(jsod.sod_config(400, end_time=0.1))
    for dtype in ("float32", "float64"):
        pairs = (
            (sod.sod_ic(n=96, cfg=sod.sod_config(96, dtype=dtype),
                        capacity=128, device="cpu"),
             jsod.sod_ic(n=96, cfg=jsod.sod_config(96, dtype=dtype),
                         capacity=128)),
            (ring.ring_ic(n=200, seed=4, capacity=256, device="cpu",
                          cfg=sod.SimConfig(fixed_h=2.0, dtype=dtype)),
             jring.ring_ic(n=200, seed=4, capacity=256,
                           cfg=jsod.SimConfig(fixed_h=2.0, dtype=dtype))))
        for (st, cfg), (jst, jcfg) in pairs:
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            ours, theirs = tstate.to_numpy(st), jax_state_dict(jst)
            for group in ("particles", "sinks"):
                assert ours[group].keys() == theirs[group].keys()
                for name, a in theirs[group].items():
                    np.testing.assert_array_equal(ours[group][name], a,
                                                  err_msg=f"{group}.{name}")
            for name in ("t", "dt", "stats"):
                np.testing.assert_array_equal(ours[name], theirs[name])


def test_sod_l2_on_the_sorted_engine():
    """tests/test_sod.py's sorted case on the port (CPU, float32): the L2
    density error at n = 400, t = 0.1 within 5e-4 of the JAX package's
    0.01383 (docs/results/sod/README.md)."""
    from summersph_tpu_torch.integrate import run_until
    from summersph_tpu_torch.models.sod import (sod_config, sod_ic,
                                                sod_l2_density_error)

    n = 400
    cfg = sod_config(n=n).with_(end_time=0.1, neighbor_mode="sorted",
                                sorted_block=128, window_group=32,
                                window_blocks=4)
    state, _ = sod_ic(n=n, cfg=cfg, device="cpu")
    state = run_until(state, 0.1, cfg)
    err = sod_l2_density_error(state)
    assert abs(err - 0.01383) < 5e-4, err
    assert int(state.particles.n_alive) == n
