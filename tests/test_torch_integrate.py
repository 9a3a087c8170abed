"""The port's main path as a whole against the JAX package: the disc
initial state, then prime + 1 step and prime + 10 steps of the bench
geometry scaled to N = 2048, in float64 on the CPU.

The JAX side runs the XLA sorted engine (use_pallas=False), which computes
the same sums as the Pallas kernels without interpret mode's cost, and
compiles two programs: `prime` and `run_steps(..., 1)`, the latter called
ten times for the 10-step comparison (the same steps as one
`run_steps(..., 10)` scan; the stats maximum is taken on the host).
Comparisons are per pid: the JAX sort is unstable.
"""

import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.integrate import prime as jax_prime
from summersph_tpu.integrate import run_steps as jax_run_steps
from summersph_tpu.models.disc import disc_ic as jax_disc_ic
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.diagnostics import format_report, measure
from summersph_tpu_torch.integrate import (check_health, prime, run_steps,
                                           step, warn_stats)
from summersph_tpu_torch.models.disc import disc_ic

from test_torch_config_state import jax_state_dict
from test_torch_sharded import one_rank_mesh  # noqa: F401 (a fixture)

N = 2048
H0 = 100.0 * (60.0 / N) ** (1.0 / 3.0) / 2.0   # bench.py's h0 formula


def _cfg_kwargs():
    # bench.py's headline config at gravity='none', scaled to N.
    # window_blocks=4 makes the XLA engine's windows cover every candidate
    # (stats slot 0 stays 0 on both sides).
    return dict(fixed_h=H0, gravity="none", neighbor_mode="sorted",
                use_pallas=False, sorted_block=128, window_group=64,
                window_blocks=4, gamma=1.4, bounding_size=1500.0,
                dt_init=1e-4, dt_min=1e-5, dt_max=1e-3, dtype="float64")


def _ic(pkg_disc_ic, cfg):
    kw = {"device": "cpu"} if pkg_disc_ic is disc_ic else {}
    return pkg_disc_ic(n=N, r_max=100.0, m_star=5.0, h0=H0,
                       rotation="keplerian", cfg=cfg, seed=0, **kw)[0]


@pytest.fixture(scope="module")
def runs():
    """(port states, JAX state dicts) after prime + 1 and prime + 10."""
    jcfg = JaxConfig(**_cfg_kwargs())
    cfg = SimConfig(**_cfg_kwargs())
    j0 = jax_prime(_ic(jax_disc_ic, jcfg), jcfg)
    j1 = jax_run_steps(j0, jcfg, 1)
    j10, stats_max = j1, np.asarray(j1.stats)
    for _ in range(9):
        j10 = jax_run_steps(j10, jcfg, 1)
        stats_max = np.maximum(stats_max, np.asarray(j10.stats))
    d10 = jax_state_dict(j10)
    d10["stats"] = stats_max

    t0 = prime(_ic(disc_ic, cfg), cfg)
    return ({"1": run_steps(t0, cfg, 1), "10": run_steps(t0, cfg, 10)},
            {"1": jax_state_dict(j1), "10": d10})


def test_disc_ic_matches_jax_exactly():
    for dtype in ("float32", "float64"):
        kw = {**_cfg_kwargs(), "dtype": dtype}
        ours = tstate.to_numpy(_ic(disc_ic, SimConfig(**kw)))
        theirs = jax_state_dict(_ic(jax_disc_ic, JaxConfig(**kw)))
        for group in ("particles", "sinks"):
            assert ours[group].keys() == theirs[group].keys()
            for name, a in theirs[group].items():
                np.testing.assert_array_equal(ours[group][name], a,
                                              err_msg=f"{group}.{name}")
        for name in ("t", "dt", "stats"):
            np.testing.assert_array_equal(ours[name], theirs[name])


@pytest.mark.parametrize("n_steps,rtol", [("1", 1e-9), ("10", 1e-7)])
def test_steps_match_jax(runs, n_steps, rtol):
    ours = tstate.to_numpy(runs[0][n_steps])
    theirs = runs[1][n_steps]
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-12)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])

    po, pt = ours["particles"], theirs["particles"]
    oo, ot = np.argsort(po["pid"]), np.argsort(pt["pid"])
    np.testing.assert_array_equal(po["pid"][oo], pt["pid"][ot])
    np.testing.assert_array_equal(po["alive"][oo], pt["alive"][ot])
    for name in ("pos", "vel", "u", "rho", "acc"):
        np.testing.assert_allclose(po[name][oo], pt[name][ot], rtol=rtol,
                                   err_msg=name)

    so, st = ours["sinks"], theirs["sinks"]
    for name in ("alive", "mass", "radius"):
        np.testing.assert_array_equal(so[name], st[name], err_msg=name)
    for name in ("pos", "vel", "acc", "spin"):
        np.testing.assert_allclose(so[name], st[name], rtol=1e-12,
                                   atol=1e-300, err_msg=name)


def test_health_and_diagnostics_after_ten_steps(runs):
    st = runs[0]["10"]
    check_health(st)
    assert warn_stats(st) is False
    d = measure(st, include_potential=True)
    assert int(d["n_gas"]) == N
    for key in ("e_kin", "e_int", "e_pot", "mass_gas", "rho_max"):
        assert np.isfinite(float(d[key]))
    assert "N=2048+1s" in format_report(d)


@pytest.mark.parametrize("change", [
    dict(decomp="slab"), dict(decomp="slab", fixed_h=None),
    dict(decomp="slab", neighbor_mode="dense"), dict(dt_bins=2),
    dict(dt_bins=2, fixed_h=None), dict(dt_bins=2, gravity="pm"),
    dict(decomp="slab", dt_bins=2)])
def test_unported_configurations_raise(change, one_rank_mesh):
    """The port refuses none of these on a mesh (here of one gloo rank):
    the slab decomposition runs there (tests/test_torch_decomp.py holds it
    against JAX), with 'dense' on gathered columns, and block timesteps
    take the global step of dt_bins 1, as the JAX package's sharded
    steps do, bit for bit.  One device runs every configuration, the
    dense engine included (tests/test_torch_dense.py); gather mode runs on
    several (tests/test_torch_sharded.py)."""
    cfg = SimConfig(**{**_cfg_kwargs(), "dtype": "float32"})
    st = _ic(disc_ic, cfg)

    def one_step(c):
        return step(prime(st, c, axis_name=one_rank_mesh), c,
                    axis_name=one_rank_mesh)

    out = one_step(cfg.with_(**change))
    check_health(out)
    assert int(out.stats[6]) == 0   # decomp_pressure
    if change.get("dt_bins", 1) > 1:
        ref = one_step(cfg.with_(**{**change, "dt_bins": 1}))
        for name in ("pid", "pos", "vel", "u", "rho", "h", "acc"):
            assert torch.equal(getattr(out.particles, name),
                               getattr(ref.particles, name)), name
        assert torch.equal(out.t, ref.t) and torch.equal(out.dt, ref.dt)


def test_multi_device_raises(one_rank_mesh):
    """The JAX package's axis names (strings) are no mesh in the port:
    a step on one raises TypeError.  A step on a mesh with block
    timesteps and the slab decomposition runs (the global step)."""
    cfg = SimConfig(**{**_cfg_kwargs(), "dtype": "float32"})
    out = step(_ic(disc_ic, cfg), cfg.with_(decomp="slab", dt_bins=3),
               axis_name=one_rank_mesh)
    assert int(out.particles.n_alive) == N
    with pytest.raises(TypeError):
        step(_ic(disc_ic, cfg), cfg, axis_name="dp")


def test_kahan_carry_and_reference_schedule_run():
    """cfg.kahan_u carries u_c through the sort; reuse_forces=False runs
    the two-evaluation schedule.  Both keep the state finite and the
    particle ids a permutation."""
    base = SimConfig(**{**_cfg_kwargs(), "dtype": "float32"})
    for cfg in (base.with_(kahan_u=True), base.with_(reuse_forces=False)):
        st = run_steps(prime(_ic(disc_ic, cfg), cfg), cfg, 2)
        check_health(st)
        assert (st.particles.u_c is not None) == cfg.kahan_u
        assert torch.equal(torch.sort(st.particles.pid).values,
                           torch.arange(N, dtype=torch.int32))
