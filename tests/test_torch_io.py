"""The port's I/O against the JAX package's: the reference `.txt` IC and
snapshot files, `parameters.txt` and npz checkpoints.

The cases of tests/test_io.py run on the port; then the files cross the
packages: a snapshot and a `parameters.txt` written by the port are the
JAX writer's bytes, one IC file reads to equal arrays in both, and a
checkpoint written by either loads in the other with every field equal.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import summersph_tpu.config as jconfig
import summersph_tpu.io as jio
from summersph_tpu.state import Particles as JParticles
from summersph_tpu.state import SimState as JSimState
from summersph_tpu.state import Sinks as JSinks
from summersph_tpu_torch import config as tconfig
from summersph_tpu_torch import io as tio
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig

from test_torch_config_state import jax_state_dict

N_DEMO = 17


def _demo_arrays(n=N_DEMO):
    rng = np.random.default_rng(0)
    return dict(pos=rng.standard_normal((n, 3)) * 10,
                vel=rng.standard_normal((n, 3)), mass=rng.random(n) + 0.1,
                u=rng.random(n) + 0.5, alpha=rng.random(n),
                h=rng.random(n) + 1.0)


def _sinks_kw(with_sink):
    if with_sink:
        return dict(pos=[[1.0, 2.0, 3.0]], vel=[[0.1, 0, 0]], mass=[5.0],
                    radius=[3.5], capacity=4)
    return dict(pos=np.zeros((1, 3)), vel=np.zeros((1, 3)), mass=[0.0],
                radius=[0.0])


def _demo_state(with_sink=True, capacity=None):
    """tests/test_io.py's demo state, built by the port on the CPU."""
    p = tstate.Particles.create(**_demo_arrays(), capacity=capacity,
                                device="cpu")
    s = tstate.Sinks.create(**_sinks_kw(with_sink), device="cpu")
    return tstate.SimState.create(p, s, t=1.25, dt=3e-3)


def _jax_demo_state(capacity=None, dtype="float32"):
    import jax.numpy as jnp

    dt = jnp.float64 if dtype == "float64" else jnp.float32
    p = JParticles.create(**_demo_arrays(), capacity=capacity, dtype=dt)
    s = JSinks.create(**_sinks_kw(True), dtype=dt)
    return JSimState.create(p, s, t=1.25, dt=3e-3)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("columns", [8, 9, 10])
def test_txt_round_trip(tmp_path, columns):
    st = _demo_state()
    path = tmp_path / "ic.txt"
    tio.write_snapshot_txt(path, st.particles, st.sinks, columns=columns)
    p2, s2 = tio.read_ic_txt(path, SimConfig(fixed_h=2.5), device="cpu")

    assert int(p2.n_alive) == int(st.particles.n_alive) == N_DEMO
    assert int(s2.n_alive) == 1
    for name in ("pos", "u") + (("alpha",) if columns >= 9 else ()) \
            + (("h",) if columns >= 10 else ()):
        np.testing.assert_allclose(_np(getattr(p2, name)),
                                   _np(getattr(st.particles, name)),
                                   rtol=1e-6, err_msg=name)
    assert float(s2.mass[0]) == pytest.approx(5.0)
    if columns < 10:  # no h column: the config's fixed h
        assert np.allclose(_np(p2.h), 2.5)


def test_no_sink_gives_dummy_origin_sink(tmp_path):
    st = _demo_state(with_sink=False)
    st = st.replace(sinks=st.sinks.replace(
        alive=torch.zeros_like(st.sinks.alive)))
    path = tmp_path / "nosink.txt"
    tio.write_snapshot_txt(path, st.particles, st.sinks)
    _, s2 = tio.read_ic_txt(path, SimConfig(), device="cpu")
    assert int(s2.n_alive) == 1
    assert float(s2.mass[0]) == 0.0
    np.testing.assert_allclose(_np(s2.pos)[0], 0.0)
    assert s2.capacity == SimConfig().sink_capacity


def test_malformed_file_raises(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("header\n1 2 3\n")
    with pytest.raises(ValueError, match="columns"):
        tio.read_ic_txt(path, SimConfig(), device="cpu")


def _params_cfg(pkg):
    return pkg.SimConfig(fixed_h=None, bounding_size=900.0, max_depth=12,
                         theta=0.7, gamma=1.6667, eta=1.3,
                         convergence_criteria=1e-4, max_length=50.0,
                         timestep_scale=0.1, end_time=123.0)


def test_params_round_trip(tmp_path):
    cfg = _params_cfg(tconfig)
    path = tmp_path / "parameters.txt"
    tconfig.write_parameters_txt(path, cfg)
    cfg2 = tconfig.read_parameters_txt(path)
    for f in tconfig._PARAM_FIELDS:
        assert getattr(cfg2, f) == pytest.approx(getattr(cfg, f))
    assert cfg2.fixed_h is None  # a parameter file implies variable h
    # with a base config, fixed_h is the base's
    base = SimConfig(fixed_h=3.0)
    assert tconfig.read_parameters_txt(path, base=base).fixed_h == 3.0


def test_npz_checkpoint_exact_round_trip(tmp_path):
    st = _demo_state()
    path = tmp_path / "ck.npz"
    tio.save_npz(path, st)
    st2 = tio.load_npz(path, device="cpu")
    assert float(st2.t) == float(st.t) and float(st2.dt) == float(st.dt)
    for tree, tree2 in ((st.particles, st2.particles),
                        (st.sinks, st2.sinks)):
        for f in dataclasses.fields(tree):
            a, b = getattr(tree, f.name), getattr(tree2, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert torch.equal(a, b), f.name
    assert not (tmp_path / "ck.npz.tmp").exists()


def test_npz_loads_older_files(tmp_path):
    """A field missing from the file takes its default, a short stats
    vector is padded with zeros, unknown config keys are dropped."""
    st = _demo_state()
    path = tmp_path / "ck.npz"
    tio.save_npz(path, st, SimConfig(gamma=1.5))
    data = dict(np.load(path))
    data["stats"] = data["stats"][:3]
    raw = dict(dataclasses.asdict(SimConfig(gamma=1.5)), no_such_knob=7)
    data["config_json"] = np.frombuffer(
        __import__("json").dumps(raw).encode(), dtype=np.uint8)
    old = tmp_path / "old.npz"
    np.savez(old, **data)
    st2, cfg = tio.load_npz_with_config(old, device="cpu")
    assert cfg == SimConfig(gamma=1.5)
    assert st2.stats.tolist() == [0] * len(tstate.STATS_FIELDS)
    assert st2.particles.u_c is None and st2.pm_r_s is None


@pytest.mark.parametrize("columns", [8, 9, 10])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_snapshot_bytes_match_jax(tmp_path, columns, dtype):
    """One JAX state, with dead particle slots and dead sink slots, carried
    across by from_numpy: both writers give the same bytes."""
    jst = _jax_demo_state(capacity=N_DEMO + 3, dtype=dtype)
    st = tstate.from_numpy(jax_state_dict(jst), device="cpu")
    jio.write_snapshot_txt(tmp_path / "jax.txt", jst.particles, jst.sinks,
                           columns=columns)
    tio.write_snapshot_txt(tmp_path / "port.txt", st.particles, st.sinks,
                           columns=columns)
    ours = (tmp_path / "port.txt").read_bytes()
    assert ours == (tmp_path / "jax.txt").read_bytes()
    assert len(ours.splitlines()) == 1 + N_DEMO + 1


def test_parameters_bytes_match_jax(tmp_path):
    jconfig.write_parameters_txt(tmp_path / "jax.txt", _params_cfg(jconfig))
    tconfig.write_parameters_txt(tmp_path / "port.txt", _params_cfg(tconfig))
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())
    theirs = jconfig.read_parameters_txt(tmp_path / "port.txt")
    ours = tconfig.read_parameters_txt(tmp_path / "jax.txt")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("columns", [8, 10])
def test_read_ic_matches_jax(tmp_path, columns):
    """One file, read by both packages with a sink capacity above the file's
    sink count: equal arrays, field for field."""
    st = _demo_state()
    path = tmp_path / "ic.txt"
    tio.write_snapshot_txt(path, st.particles, st.sinks, columns=columns)
    for dtype in ("float32", "float64"):
        kw = dict(fixed_h=1.7, sink_capacity=5, sink_radius=2.0, dtype=dtype)
        jp, js = jio.read_ic_txt(path, jconfig.SimConfig(**kw), capacity=20)
        p, s = tio.read_ic_txt(path, SimConfig(**kw), capacity=20,
                               device="cpu")
        theirs = jax_state_dict(JSimState.create(jp, js))
        ours = tstate.to_numpy(tstate.SimState.create(p, s))
        for group in ("particles", "sinks"):
            assert ours[group].keys() == theirs[group].keys()
            for name, a in theirs[group].items():
                assert ours[group][name].dtype == a.dtype, (group, name)
                np.testing.assert_array_equal(ours[group][name], a,
                                              err_msg=f"{group}.{name}")


def _carrying_jax_state():
    """A float64 JAX state with every optional field set."""
    import jax.numpy as jnp

    jst = _jax_demo_state(capacity=20, dtype="float64")
    p = jst.particles
    return jst.replace(
        particles=p.replace(u_c=jnp.full_like(p.u, 1e-9),
                            acc_ext=jnp.ones_like(p.pos) * 0.25),
        pm_r_s=jnp.asarray(0.5, jnp.float64),
        stats=jnp.arange(len(tstate.STATS_FIELDS), dtype=jnp.int32))


def _assert_same_state(ours: dict, theirs: dict):
    assert ours.keys() == theirs.keys()
    for group in ("particles", "sinks"):
        assert ours[group].keys() == theirs[group].keys()
        for name, a in theirs[group].items():
            assert ours[group][name].dtype == a.dtype, (group, name)
            np.testing.assert_array_equal(ours[group][name], a,
                                          err_msg=f"{group}.{name}")
    for name in ("t", "dt", "stats", "pm_r_s"):
        assert ours[name].dtype == theirs[name].dtype, name
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    jst = _carrying_jax_state()
    jcfg = jconfig.SimConfig(gravity="pm", pm_every=4, kahan_u=True,
                             fixed_h=None, dtype="float64")
    jio.save_npz(tmp_path / "ck.npz", jst, jcfg)
    st, cfg = tio.load_npz_with_config(tmp_path / "ck.npz", device="cpu")
    _assert_same_state(tstate.to_numpy(st), jax_state_dict(jst))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    from summersph_tpu.io.checkpoint import load_npz_with_config

    st = tstate.from_numpy(jax_state_dict(_carrying_jax_state()),
                           device="cpu")
    cfg = SimConfig(gravity="pm", pm_every=4, kahan_u=True, fixed_h=None,
                    dtype="float64")
    tio.save_npz(tmp_path / "ck.npz", st, cfg)
    jst, jcfg = load_npz_with_config(tmp_path / "ck.npz")
    _assert_same_state(jax_state_dict(jst), tstate.to_numpy(st))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


def test_io_and_models_default_to_the_card(tmp_path):
    """As test_entry_points_default_to_the_card: the new entry points put
    their tensors on the card unless the caller names another device; with
    no card the default raises instead of moving to the CPU."""
    from summersph_tpu_torch.models.ring import ring_ic
    from summersph_tpu_torch.models.sod import sod_ic
    from summersph_tpu_torch.tools.density_image import (
        density_grid, projected_density, projected_density_from_snapshot)
    from summersph_tpu_torch.tools.make_ics import make_ics

    fns = (tio.read_ic_txt, tio.load_npz, tio.load_npz_with_config, sod_ic,
           ring_ic, make_ics, density_grid, projected_density,
           projected_density_from_snapshot)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    st = _demo_state()
    tio.write_snapshot_txt(tmp_path / "ic.txt", st.particles, st.sinks)
    tio.save_npz(tmp_path / "ck.npz", st)
    calls = (lambda: tio.read_ic_txt(tmp_path / "ic.txt"),
             lambda: tio.load_npz(tmp_path / "ck.npz"),
             lambda: sod_ic(n=16), lambda: ring_ic(n=16),
             lambda: make_ics("sod", str(tmp_path / "sod.txt"), n=16))
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()
