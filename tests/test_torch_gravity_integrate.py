"""The self-gravity path through the port's entry points against the JAX
package: the fused force sums, the fused and separate short-range routes,
prime + steps with gravity='pm', the held far field (pm_every), and the
host-side decision of when the mesh is solved.

The JAX side runs its XLA sorted engine (use_pallas=False) for the
separate route and its Pallas kernels in interpret mode for the fused one,
in float64.  Comparisons are per pid: the JAX sort is unstable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.integrate import prime as jax_prime
from summersph_tpu.integrate import run_steps as jax_run_steps
from summersph_tpu.models.disc import disc_ic as jax_disc_ic
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import (check_health, force_eval,
                                           init_carries, prime, run_steps,
                                           step)
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
from summersph_tpu_torch.ops.sorted_grid import sort_particles

from test_density_forces import lattice_particles
from test_torch_config_state import jax_state_dict, port_particles


def _f(p, dtype):
    """JAX particles with every float field cast to `dtype`."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, p)


def _by_pid(d):
    """The particle dict of a state dict, rows ordered by pid."""
    order = np.argsort(d["pid"])
    return {k: v[order] for k, v in d.items()}


def _compare_states(ours, theirs, rtol, fields=("pos", "vel", "u", "rho",
                                                "acc")):
    ours, theirs = tstate.to_numpy(ours), jax_state_dict(theirs)
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-12)
    po, pt = _by_pid(ours["particles"]), _by_pid(theirs["particles"])
    np.testing.assert_array_equal(po["pid"], pt["pid"])
    np.testing.assert_array_equal(po["alive"], pt["alive"])
    for name in fields:
        np.testing.assert_allclose(po[name], pt[name], rtol=rtol,
                                   err_msg=name)
    for name in ("pos", "vel", "acc"):
        np.testing.assert_allclose(ours["sinks"][name],
                                   theirs["sinks"][name], rtol=1e-12,
                                   atol=1e-300, err_msg=f"sinks.{name}")
    return ours, theirs


# ------------------------------------------------ fused force kernel form

# window_group=128: one row group per Pallas block keeps interpret mode's
# program small
_LATTICE_KW = dict(fixed_h=1.3, gravity="pm", grav_grid=32,
                   neighbor_mode="sorted", use_pallas=True,
                   sorted_block=128, window_group=128, window_blocks=5,
                   pallas_window=640, pallas_fetch_window=768)


def test_fused_force_sums_match_pallas_interpret_f64():
    """tests/test_gravity.py's jittered lattice: the plain fused force
    sums (SPH and short-range gravity) against `pallas_pair_eval` with
    grav_split in interpret mode, in float64."""
    from summersph_tpu.ops.pallas_pairs import (pallas_pair_eval,
                                                window_overflow)
    from summersph_tpu.ops.pm_gravity import pm_geometry as jax_geometry
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort

    jp = _f(lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.2),
            jnp.float64)
    jcfg = JaxConfig(**_LATTICE_KW, pallas_interpret=True, dtype="float64")
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(window_overflow(jgrid, jcfg)) == 0
    r_s = jax_geometry(jp2, jcfg)[2]
    r_cut = jcfg.effective_rcut_rs() * r_s
    assert float(r_cut) <= float(jgrid.cell_size)
    jout = pallas_pair_eval(jp2, jcfg, jgrid, interpret=True,
                            grav_split=(r_s, r_cut))
    order = np.argsort(np.asarray(jout[0].pid))
    theirs = [np.asarray(a)[order] for a in
              (jout[0].rho, jout[1], jout[2], jout[3], jout[4])]

    cfg = SimConfig(**_LATTICE_KW, dtype="float64")
    p2, grid = sort_particles(port_particles(jp), cfg)
    split = tuple(torch.tensor(float(v), dtype=torch.float64)
                  for v in (r_s, r_cut))
    out = cuda_pairs.pair_eval(p2, cfg, grid, split)
    order = np.argsort(out[0].pid.numpy())
    ours = [a.numpy()[order] for a in
            (out[0].rho, out[1], out[2], out[3], out[4])]
    assert np.abs(ours[4]).max() > 0.0
    for name, a, b in zip(("rho", "acc", "du", "dalpha", "acc_grav"), ours,
                          theirs):
        np.testing.assert_allclose(a, b, rtol=1e-9,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=name)


def _lattice_state(h, jitter):
    jp = _f(lattice_particles(nside=8, spacing=1.0, h=h, jitter=jitter),
            jnp.float32)
    return tstate.SimState.create(port_particles(jp),
                                  tstate.Sinks.zeros(2, device="cpu"),
                                  dt=1e-4)


def test_fused_equals_separate_short_range():
    """grav_fuse_short on the lattice, where r_cut fits the SPH cell: the
    short range inside the force kernel equals the separate pass within
    the JAX test's 3e-6 of the largest acceleration."""
    accs = {}
    for fuse in (False, True):
        cfg = SimConfig(**_LATTICE_KW, grav_fuse_short=fuse)
        out = prime(_lattice_state(1.3, 0.2), cfg)
        order = np.argsort(out.particles.pid.numpy())
        accs[fuse] = out.particles.acc.numpy()[order]
    scale = np.abs(accs[False]).max()
    np.testing.assert_allclose(accs[True], accs[False], atol=3e-6 * scale)


def test_fused_flags_an_rcut_violation():
    """A coarse mesh puts r_cut beyond the SPH cell 2 h, where the JAX
    package's fused step reports every live row in grav_window_overflow
    (tests/test_gravity.py).  The port's fused step sorts on a cell of
    r_cut instead, so it reports no row and equals the separate short
    range within test_fused_equals_separate_short_range's 3e-6 of the
    largest acceleration; where r_cut fits, the cell stays 2 h."""
    st = _lattice_state(0.35, 0.1)
    kw = {**_LATTICE_KW, "fixed_h": 0.35, "grav_grid": 8}
    r_cut = (SimConfig(**kw).effective_rcut_rs()
             * float(pm_gravity.pm_geometry(st.particles, SimConfig(**kw))[2]))
    assert r_cut > 2 * 0.35
    accs = {}
    for fuse in (False, True):
        p, _, (grid, grav_over, _) = force_eval(
            st.particles, st.sinks, SimConfig(**kw, grav_fuse_short=fuse))
        assert int(grav_over) == 0
        assert float(grid.cell_size) == pytest.approx(
            r_cut if fuse else 2 * 0.35, rel=1e-6)
        accs[fuse] = p.acc.numpy()[np.argsort(p.pid.numpy())]
    scale = np.abs(accs[False]).max()
    np.testing.assert_allclose(accs[True], accs[False], atol=3e-6 * scale)
    st = _lattice_state(1.3, 0.2)
    ok = SimConfig(**_LATTICE_KW, grav_fuse_short=True)
    _, _, (grid, grav_over, _) = force_eval(st.particles, st.sinks, ok)
    assert int(grav_over) == 0
    assert float(grid.cell_size) == pytest.approx(2 * 1.3, rel=1e-6)


def test_fused_guards_follow_jax():
    st = _lattice_state(1.3, 0.2)
    for change in (dict(use_pallas=False), dict(neighbor_mode="grid")):
        cfg = SimConfig(**{**_LATTICE_KW, **change}, grav_fuse_short=True)
        with pytest.raises(ValueError):
            force_eval(st.particles, st.sinks, cfg)
    with pytest.raises(ValueError):
        force_eval(st.particles, st.sinks,
                   SimConfig(**{**_LATTICE_KW, "neighbor_mode": "grid"},
                             pm_every=2))


def test_fused_prime_and_held_step_match_jax_interpret():
    """prime + run_steps(2) with grav_fuse_short and pm_every=2 (a solved
    step, then a held one) against the JAX engine's Pallas kernels in
    interpret mode, in float64."""
    from summersph_tpu.state import SimState as JSimState
    from summersph_tpu.state import Sinks as JSinks

    jp = _f(lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.2),
            jnp.float64)
    kw = dict(_LATTICE_KW, grav_fuse_short=True, pm_every=2,
              dtype="float64", dt_init=1e-3, dt_min=1e-5, dt_max=1e-2,
              bounding_size=1500.0)
    jcfg = JaxConfig(**kw, pallas_interpret=True)
    js = JSinks.create(pos=[[3.5, 3.5, 3.5]], vel=np.zeros((1, 3)),
                       mass=[0.5], radius=[0.3], capacity=2,
                       dtype=jnp.float64)
    jst = JSimState.create(jp, js, dt=1e-3)
    jout = jax_run_steps(jax_prime(jst, jcfg), jcfg, 2)

    st = tstate.from_numpy(jax_state_dict(jst), device="cpu")
    cfg = SimConfig(**kw)
    out = run_steps(prime(st, cfg), cfg, 2)
    ours, theirs = _compare_states(out, jout, rtol=1e-9)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    np.testing.assert_allclose(ours["pm_r_s"], theirs["pm_r_s"],
                               rtol=1e-12)
    po, pt = _by_pid(ours["particles"]), _by_pid(theirs["particles"])
    np.testing.assert_allclose(po["acc_ext"], pt["acc_ext"], rtol=1e-9,
                               atol=1e-12 * np.abs(pt["acc_ext"]).max())


# ----------------------------------------------- separate route, steps

N = 2048
H0 = 100.0 * (60.0 / N) ** (1.0 / 3.0) / 2.0   # bench.py's h0 formula


def _disc_kw():
    # bench.py's gravity config scaled to N = 2048, on the XLA engine with
    # windows that just cover every SPH and gravity candidate (the JAX
    # compile time grows with them)
    return dict(fixed_h=H0, gravity="pm", grav_grid=32, grav_fft="xla",
                neighbor_mode="sorted", use_pallas=False, sorted_block=128,
                window_group=32, window_blocks=4, grav_window_blocks=4,
                gamma=1.4, bounding_size=1500.0, dt_init=1e-4, dt_min=1e-5,
                dt_max=1e-3, dtype="float64")


@pytest.fixture(scope="module")
def pm_runs():
    """(port states, JAX states) after prime + 1 and prime + 10 steps of
    the 2048-particle disc with gravity='pm' (separate short range)."""
    jcfg, cfg = JaxConfig(**_disc_kw()), SimConfig(**_disc_kw())
    ic = dict(n=N, r_max=100.0, m_star=5.0, h0=H0, rotation="keplerian",
              seed=0)
    j0 = jax_prime(jax_disc_ic(cfg=jcfg, **ic)[0], jcfg)
    j1 = jax_run_steps(j0, jcfg, 1)
    j10, stats = j1, np.asarray(j1.stats)
    for _ in range(9):
        j10 = jax_run_steps(j10, jcfg, 1)
        stats = np.maximum(stats, np.asarray(j10.stats))
    j10 = j10.replace(stats=jnp.asarray(stats))
    t0 = prime(disc_ic(cfg=cfg, device="cpu", **ic)[0], cfg)
    return ({"1": run_steps(t0, cfg, 1), "10": run_steps(t0, cfg, 10)},
            {"1": j1, "10": j10})


@pytest.mark.parametrize("n_steps,rtol", [("1", 1e-9), ("10", 1e-7)])
def test_pm_steps_match_jax(pm_runs, n_steps, rtol):
    ours, theirs = _compare_states(pm_runs[0][n_steps],
                                   pm_runs[1][n_steps], rtol)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    assert not ours["stats"].any()
    check_health(pm_runs[0][n_steps])


def test_pm_every_run_steps_match_jax():
    """tests/test_pm_every.py's rigid-rotating cloud with pm_every=4:
    run_steps(6) solves on steps 0 and 4 and holds in between; positions,
    velocities, the held acc_ext and pm_r_s match the JAX engine."""
    kw = dict(fixed_h=18.0, gravity="pm", grav_grid=32, grav_fft="xla",
              neighbor_mode="sorted", use_pallas=False, sorted_block=128,
              window_group=32, window_blocks=3, grav_window_blocks=3,
              gamma=1.4, bounding_size=1500.0, sink_capacity=4,
              dt_init=2e-4, dt_min=1e-6, dt_max=1e-3, pm_every=4,
              dtype="float64")
    ic = dict(n=384, r_max=50.0, m_disc=20.0, m_star=1.0, h0=18.0,
              rotation="rigidbody", v_circ=2.0, sink_capacity=4, seed=7)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    jout = jax_run_steps(jax_prime(jax_disc_ic(cfg=jcfg, **ic)[0], jcfg),
                         jcfg, 6)
    pm_gravity.pm_long_range.solves = 0
    out = run_steps(prime(disc_ic(cfg=cfg, device="cpu", **ic)[0], cfg),
                    cfg, 6)
    assert pm_gravity.pm_long_range.solves == 1 + 2
    ours, theirs = _compare_states(out, jout, rtol=1e-9)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    np.testing.assert_allclose(ours["pm_r_s"], theirs["pm_r_s"],
                               rtol=1e-12)
    assert float(ours["pm_r_s"]) > 0.0
    po, pt = _by_pid(ours["particles"]), _by_pid(theirs["particles"])
    np.testing.assert_allclose(po["acc_ext"], pt["acc_ext"], rtol=1e-9,
                               atol=1e-12 * np.abs(pt["acc_ext"]).max())


def test_far_field_solves_on_the_host_schedule():
    """`step` with a nonzero phase on a state that never solved reads the
    held split, finds it 0 and solves; once solved, a nonzero phase holds
    the far field.  Dropping pm_every drops the carries."""
    cfg = SimConfig(**{**_disc_kw(), "dtype": "float32"}, pm_every=4)
    st = init_carries(disc_ic(n=512, r_max=100.0, h0=15.0, cfg=cfg, seed=2,
                              device="cpu")[0], cfg)
    assert float(st.pm_r_s) == 0.0
    assert torch.equal(st.particles.acc_ext, torch.zeros_like(
        st.particles.pos))
    cfg1 = cfg.with_(reuse_forces=False)  # no primed rates needed
    pm_gravity.pm_long_range.solves = 0
    solved = step(st, cfg1, pm_phase=1)
    assert pm_gravity.pm_long_range.solves == 2  # both evaluations solve
    assert float(solved.pm_r_s) > 0.0
    held = step(solved, cfg1, pm_phase=1)
    assert pm_gravity.pm_long_range.solves == 2
    assert torch.equal(held.pm_r_s, solved.pm_r_s)
    assert pm_gravity.recompute_far_field(None, solved.pm_r_s)
    assert pm_gravity.recompute_far_field(0, solved.pm_r_s)
    assert not pm_gravity.recompute_far_field(3, solved.pm_r_s)
    assert not pm_gravity.recompute_far_field(3, st.pm_r_s,
                                              held_valid=True)
    dropped = init_carries(solved, cfg.with_(pm_every=1))
    assert dropped.pm_r_s is None and dropped.particles.acc_ext is None
