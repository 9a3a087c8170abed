"""The port's run loop against the JAX package's: `run_until` and `simulate`
on a 2048-particle disc in float64, `check_coverage`, the health checks,
`nan_guard`, `compact`, the kernel table, and `neighbor_mode='grid'`,
which the port runs on its sorted engine, against the JAX hashed grid.

The JAX side runs its XLA engines (use_pallas=False) and compiles each
configuration once: the sorted disc's `prime` and `run_steps(..., 8)`
(simulate and run_until share them: one config, one segment length) and
the grid disc's `prime` and `run_steps(..., 3)`.  Comparisons are per
pid, and snapshot rows are matched by sorting them: the JAX sort is
unstable and a snapshot has no pid column.
"""

import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.models.disc import disc_ic as jax_disc_ic
from summersph_tpu_torch import integrate as tint
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.diagnostics import nan_guard
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.models.sod import sod_config, sod_ic
from summersph_tpu_torch.ops import kernels as tkernels

from test_torch_config_state import jax_state_dict

N = 2048
H0 = 100.0 * (60.0 / N) ** (1.0 / 3.0) / 2.0   # bench.py's h0 formula
# dt saturates near 7.6e-4, so a segment of 8 steps spans ~6e-3: the first
# segment stops short of tick 0, the second passes ticks 0 and 1 (saved
# twice, the same state), the third passes tick 2.
END_TIME, N_SAVES, T_STOP = 0.012, 3, 0.005


def _cfg_kwargs(**over):
    # tests/test_torch_integrate.py's config: bench.py's headline at
    # gravity='none' scaled to N; window_blocks=4 covers every candidate
    kw = dict(fixed_h=H0, gravity="none", neighbor_mode="sorted",
              use_pallas=False, sorted_block=128, window_group=64,
              window_blocks=4, gamma=1.4, bounding_size=1500.0,
              dt_init=1e-4, dt_min=1e-5, dt_max=1e-3, dtype="float64",
              end_time=END_TIME, n_saves=N_SAVES)
    kw.update(over)
    return kw


def _ic(pkg_disc_ic, cfg):
    kw = {"device": "cpu"} if pkg_disc_ic is disc_ic else {}
    return pkg_disc_ic(n=N, r_max=100.0, m_star=5.0, h0=H0,
                       rotation="keplerian", cfg=cfg, seed=0, **kw)[0]


def _simulate(pkg, ic, cfg, out_dir):
    ticks = []
    end = pkg.simulate(ic, cfg, out_dir=str(out_dir), verbose=False,
                       on_tick=lambda i, st: ticks.append((i, float(st.t))))
    return end, ticks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """simulate and run_until in both packages from the same disc."""
    import summersph_tpu.integrate as jint

    jcfg, cfg = JaxConfig(**_cfg_kwargs()), SimConfig(**_cfg_kwargs())
    jic, ic = _ic(jax_disc_ic, jcfg), _ic(disc_ic, cfg)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("tt")
    jend, jticks = _simulate(jint, jic, jcfg, jdir)
    end, ticks = _simulate(tint, ic, cfg, tdir)
    return dict(
        jax=dict(end=jax_state_dict(jend), ticks=jticks, dir=jdir,
                 until=jax_state_dict(jint.run_until(jint.prime(jic, jcfg),
                                                     T_STOP, jcfg)),
                 coverage=jint.check_coverage(jic, jcfg)),
        port=dict(end=tstate.to_numpy(end), ticks=ticks, dir=tdir,
                  until=tstate.to_numpy(tint.run_until(tint.prime(ic, cfg),
                                                       T_STOP, cfg)),
                  coverage=tint.check_coverage(ic, cfg)))


def _per_pid(d):
    p = d["particles"]
    return {k: v[np.argsort(p["pid"])] for k, v in p.items()}


def _hold_state(ours, theirs, rtol=1e-7):
    """tests/test_torch_integrate.py's 10-step tolerances, per pid."""
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-12)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    po, pt = _per_pid(ours), _per_pid(theirs)
    np.testing.assert_array_equal(po["alive"], pt["alive"])
    for name in ("pos", "vel", "u", "rho", "acc"):
        np.testing.assert_allclose(po[name], pt[name], rtol=rtol,
                                   err_msg=name)
    for name in ("pos", "vel", "mass"):
        np.testing.assert_allclose(ours["sinks"][name], theirs["sinks"][name],
                                   rtol=1e-12, atol=1e-300, err_msg=name)


def _rows(path):
    rows = np.loadtxt(path, skiprows=1, ndmin=2)
    return rows[np.lexsort(rows.T[::-1])]


def test_simulate_matches_jax(runs):
    jax, port = runs["jax"], runs["port"]
    assert [i for i, _ in port["ticks"]] == list(range(N_SAVES))
    assert len(port["ticks"]) == len(jax["ticks"])
    np.testing.assert_allclose([t for _, t in port["ticks"]],
                               [t for _, t in jax["ticks"]], rtol=1e-12)
    # one segment passed ticks 0 and 1: both saves hold its state
    assert port["ticks"][0][1] == port["ticks"][1][1]
    assert port["ticks"][-1][1] >= END_TIME
    names = sorted(f.name for f in port["dir"].iterdir())
    assert names == sorted(f.name for f in jax["dir"].iterdir())
    assert names == [f"save{i}.txt" for i in range(N_SAVES)]
    for name in names:
        ours, theirs = _rows(port["dir"] / name), _rows(jax["dir"] / name)
        assert ours.shape == theirs.shape == (N + 1, 9)
        np.testing.assert_allclose(ours, theirs, rtol=1e-7, atol=1e-12,
                                   err_msg=name)
        assert ((port["dir"] / name).read_text().splitlines()[0]
                == (jax["dir"] / name).read_text().splitlines()[0])
    _hold_state(port["end"], jax["end"])


def test_run_until_matches_jax(runs):
    ours, theirs = runs["port"]["until"], runs["jax"]["until"]
    assert float(ours["t"]) >= T_STOP
    _hold_state(ours, theirs)


def test_check_coverage_is_zero_in_both(runs):
    assert runs["port"]["coverage"] == runs["jax"]["coverage"] == 0


# --- tests/test_health.py on the port


def _poisoned_state(n=200):
    cfg = sod_config(n=n).with_(neighbor_mode="sorted")
    state, _ = sod_ic(n=n, cfg=cfg, device="cpu")
    state = tint.prime(state, cfg)
    u = state.particles.u.clone()
    u[n // 2] = torch.nan
    return state.replace(particles=state.particles.replace(u=u)), cfg


def test_injected_nan_counted_and_aborts_within_one_segment():
    state, cfg = _poisoned_state()
    assert nan_guard(state) is True
    state = tint.run_steps(state, cfg, 4)
    assert state.stats_dict()["nonfinite"] >= 1
    assert tint.warn_stats(state) is True
    with pytest.raises(tint.SimulationDiverged, match="non-finite"):
        tint.check_health(state, where="test segment")


def test_simulate_aborts_on_injected_nan():
    state, cfg = _poisoned_state()
    with pytest.raises(tint.SimulationDiverged):
        tint.simulate(state, cfg.with_(end_time=0.05, n_saves=4),
                      out_dir=None)


def test_all_dead_aborts():
    cfg = sod_config(n=64).with_(neighbor_mode="sorted")
    state, _ = sod_ic(n=64, cfg=cfg, device="cpu")
    state = state.replace(particles=state.particles.replace(
        alive=torch.zeros_like(state.particles.alive)))
    with pytest.raises(tint.SimulationDiverged, match="dead"):
        tint.check_health(state)


def test_stats_vector_matches_fields():
    cfg = sod_config(n=64).with_(neighbor_mode="sorted")
    state, _ = sod_ic(n=64, cfg=cfg, device="cpu")
    state = tint.run_steps(tint.prime(state, cfg), cfg, 1)
    assert state.stats.shape == (len(tstate.STATS_FIELDS),)
    assert set(state.stats_dict()) == set(tstate.STATS_FIELDS)
    assert nan_guard(state) is False


# --- nan_guard, compact, the kernel table


def _holey_jax_state():
    """A float64 JAX disc with every third particle dead and one NaN in a
    dead slot (which the guard must ignore)."""
    import jax.numpy as jnp

    jst = _ic(jax_disc_ic, JaxConfig(**_cfg_kwargs()))
    p = jst.particles
    alive = jnp.arange(p.capacity) % 3 != 0
    return jst.replace(particles=p.replace(
        alive=alive, rho=p.rho.at[0].set(jnp.nan)))


def test_nan_guard_and_compact_match_jax():
    import jax.numpy as jnp

    from summersph_tpu.diagnostics import nan_guard as jax_nan_guard
    from summersph_tpu.state import compact as jax_compact

    jst = _holey_jax_state()
    st = tstate.from_numpy(jax_state_dict(jst), device="cpu")
    assert nan_guard(st) is jax_nan_guard(jst) is False
    bad = jst.replace(particles=jst.particles.replace(
        vel=jst.particles.vel.at[1, 2].set(jnp.inf)))
    assert nan_guard(tstate.from_numpy(jax_state_dict(bad), device="cpu")) \
        is jax_nan_guard(bad) is True

    ours = tstate.compact(st.particles)
    theirs = jax_compact(jst.particles)
    for name in ("pid", "alive", "pos", "vel", "u", "rho", "h"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    n_live = int(st.particles.n_alive)
    assert bool(ours.alive[:n_live].all())
    assert not bool(ours.alive[n_live:].any())


def test_table_matches_closed_form_and_jax():
    """tests/test_kernels.py::test_table_matches_closed_form on the port,
    and the tables against the JAX package's."""
    import jax.numpy as jnp

    from summersph_tpu.ops.kernels import KernelTable as JaxTable

    tab, jtab = tkernels.KernelTable(nq=5000), JaxTable(nq=5000)
    h = 2.5
    r = torch.linspace(0.0, 3 * h, 777, dtype=torch.float64)
    jr = jnp.asarray(r.numpy())
    np.testing.assert_allclose(tab.w(r, h).numpy(),
                               tkernels.kernel_w(r, h).numpy(), atol=1e-7)
    np.testing.assert_allclose(tab.dw(r, h).numpy(),
                               tkernels.kernel_dw(r, h).numpy(), atol=1e-6)
    np.testing.assert_allclose(tab.grav(r, h).numpy(),
                               tkernels.grav_shape(r / h).numpy(), atol=1e-6)
    for name in ("w", "dw", "grav"):
        np.testing.assert_allclose(getattr(tab, name)(r, h).numpy(),
                                   np.asarray(getattr(jtab, name)(jr, h)),
                                   rtol=1e-12, atol=1e-15, err_msg=name)


def test_dwdh_reference_compat_matches_jax():
    import jax.numpy as jnp

    from summersph_tpu.ops.kernels import dwdh_reference_compat as jax_compat

    r = torch.linspace(0.0, 4.0, 401, dtype=torch.float64)
    h = torch.full_like(r, 1.7)
    ours = tkernels.dwdh_reference_compat(r, h)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jax_compat(jnp.asarray(r.numpy()), 1.7)),
        rtol=1e-13, atol=1e-16)
    # the reference's slip is on the 3W term: compat - exact = 6 W / h
    np.testing.assert_allclose(
        (ours - tkernels.kernel_dwdh(r, h)).numpy(),
        (6.0 * tkernels.kernel_w(r, h) / h).numpy(), rtol=1e-12, atol=1e-16)


# --- neighbor_mode='grid' on the sorted engine against the JAX hashed grid


def test_grid_mode_matches_jax_grid_engine():
    """prime + 3 steps with neighbor_mode='grid': the port's sorted engine
    against the JAX hashed grid, per pid, at the float64 tolerances of
    tests/test_density_forces.py, on a disc whose buckets do not overflow
    (n_dropped 0 before and after)."""
    import summersph_tpu.integrate as jint
    from summersph_tpu.ops.neighbors import build_grid

    kw = _cfg_kwargs(neighbor_mode="grid", cell_cap=64)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    j0 = jint.prime(_ic(jax_disc_ic, jcfg), jcfg)
    j3 = jint.run_steps(j0, jcfg, 3)
    for st in (j0, j3):
        assert int(build_grid(st.particles, jcfg).n_dropped) == 0
    t0 = tint.prime(_ic(disc_ic, cfg), cfg)
    t3 = tint.run_steps(t0, cfg, 3)
    for ours, theirs in ((t0, j0), (t3, j3)):
        ours, theirs = tstate.to_numpy(ours), jax_state_dict(theirs)
        np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
        np.testing.assert_array_equal(ours["stats"], theirs["stats"])
        po, pt = _per_pid(ours), _per_pid(theirs)
        np.testing.assert_allclose(po["rho"], pt["rho"], rtol=1e-5)
        for name in ("acc", "du", "dalpha"):
            np.testing.assert_allclose(po[name], pt[name], rtol=5e-4,
                                       atol=1e-6, err_msg=name)
        for name in ("pos", "vel", "u"):
            np.testing.assert_allclose(po[name], pt[name], rtol=1e-5,
                                       err_msg=name)


def test_grid_mode_ignores_cell_h_quantile():
    """prime + one step with neighbor_mode='grid', variable h spread from
    0.6 to 1.8 x h0 by radius and cell_h_quantile=0.5: the JAX hashed grid
    sizes its cell by 2 h_max whatever the quantile says, and so does the
    port's sorted engine under 'grid' (the quantile shrinks the cell of
    'sorted' alone), so no large-h particle loses pairs.  Per pid against
    JAX at test_grid_mode_matches_jax_grid_engine's tolerances, every
    stats slot equal (sph_clamped 0 in both)."""
    import jax.numpy as jnp
    import summersph_tpu.integrate as jint
    from summersph_tpu.ops.neighbors import build_grid

    n = 512
    kw = _cfg_kwargs(fixed_h=None, neighbor_mode="grid", cell_cap=256,
                     cell_h_quantile=0.5, eta=1.2, h_iter_max=3)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    h0 = 100.0 * (60.0 / n) ** (1.0 / 3.0) / 2.0

    jstate = jax_disc_ic(n=n, r_max=100.0, m_star=5.0, h0=h0,
                         rotation="keplerian", cfg=jcfg, seed=0)[0]
    r = jnp.linalg.norm(jstate.particles.pos, axis=1)
    jstate = jstate.replace(particles=jstate.particles.replace(
        h=h0 * (0.6 + 1.2 * r / jnp.max(r))))
    start = tstate.from_numpy(jax_state_dict(jstate), device="cpu")
    j1 = jint.step(jint.prime(jstate, jcfg), jcfg)
    assert int(build_grid(j1.particles, jcfg).n_dropped) == 0
    t1 = tint.step(tint.prime(start, cfg), cfg)
    ours, theirs = tstate.to_numpy(t1), jax_state_dict(j1)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    assert ours["stats"][1] == 0
    po, pt = _per_pid(ours), _per_pid(theirs)
    np.testing.assert_array_equal(po["alive"], pt["alive"])
    for name, rtol in (("rho", 1e-5), ("h", 1e-5), ("pos", 1e-5),
                       ("vel", 1e-5), ("u", 1e-5)):
        np.testing.assert_allclose(po[name], pt[name], rtol=rtol,
                                   err_msg=name)
    for name in ("acc", "du", "dalpha"):
        np.testing.assert_allclose(po[name], pt[name], rtol=5e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("change", [dict(pm_every=2),
                                    dict(grav_fuse_short=True)])
def test_grid_mode_keeps_the_jax_value_errors(change):
    import summersph_tpu.integrate as jint

    kw = _cfg_kwargs(neighbor_mode="grid", gravity="pm", use_pallas=True,
                     dtype="float32", **change)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jst, st = _ic(jax_disc_ic, jcfg), _ic(disc_ic, cfg)
    with pytest.raises(ValueError):
        jint.force_eval(jst.particles, jst.sinks, jcfg)
    with pytest.raises(ValueError):
        tint.force_eval(st.particles, st.sinks, cfg)


def test_dense_mode_still_raises():
    """The dense engine runs (tests/test_torch_dense.py); it still raises
    where the JAX package raises: the held far field (pm_every > 1) and
    block timesteps need the sorted engine."""
    cfg = SimConfig(**_cfg_kwargs(neighbor_mode="dense", dtype="float32"))
    st = _ic(disc_ic, cfg)
    with pytest.raises(ValueError):
        tint.prime(st, cfg.with_(gravity="pm", pm_every=2))
    binned = cfg.with_(dt_bins=2)
    with pytest.raises(ValueError):
        tint.run_steps(tint.prime(st, binned), binned, 1)
    assert tint.check_coverage(st, cfg) == 0
