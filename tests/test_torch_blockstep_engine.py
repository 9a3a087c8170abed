"""Block timesteps through the port's entry points (`prime` + `run_steps`
with cfg.dt_bins > 1) against the JAX package's engine, in float64 on the
CPU, at small N.

The JAX side runs its XLA sorted engine (use_pallas=False): it evaluates
every row and merges through the activity mask, where the port evaluates
the listed window groups only, so the two agree on what a step keeps.  The
fused short range exists only in the Pallas kernels and runs them in
interpret mode.  Each JAX configuration compiles once (module fixtures).
Every comparison holds t, dt, all seven stats slots and the particles per
pid (the JAX sort is unstable); rtol 1e-9 after one base step, 1e-7 later.
"""

import numpy as np
import pytest
import torch

from summersph_tpu import blockstep as jax_blockstep
from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.integrate import prime as jax_prime
from summersph_tpu.integrate import run_steps as jax_run_steps
from summersph_tpu.models.disc import disc_ic as jax_disc_ic
from summersph_tpu.ops.timestep import dt_candidates as jax_candidates
from summersph_tpu_torch import blockstep
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import check_health, prime, run_steps
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.ops import cuda_pairs, pm_gravity

from test_torch_config_state import jax_state_dict

FIELDS = ("pos", "vel", "u", "alpha", "h", "rho", "acc", "du", "dalpha",
          "mass")


def _by_pid(d):
    order = np.argsort(d["pid"])
    return {k: v[order] for k, v in d.items()}


def _compare(ours, theirs, rtol, extra=()):
    """A port state against a JAX state: t, dt, every stats slot, the
    particle fields per pid, every sink field."""
    ours, theirs = tstate.to_numpy(ours), jax_state_dict(theirs)
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-9)
    assert ours["stats"].shape == (7,)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    po, pt = _by_pid(ours["particles"]), _by_pid(theirs["particles"])
    np.testing.assert_array_equal(po["pid"], pt["pid"])
    np.testing.assert_array_equal(po["alive"], pt["alive"])
    for name in FIELDS + tuple(extra):
        scale = np.abs(pt[name]).max()
        np.testing.assert_allclose(po[name], pt[name], rtol=rtol,
                                   atol=1e-12 * scale + 1e-300, err_msg=name)
    so, st = ours["sinks"], theirs["sinks"]
    np.testing.assert_array_equal(so["alive"], st["alive"])
    for name in ("pos", "vel", "acc", "spin", "mass", "radius"):
        scale = np.abs(st[name]).max()
        np.testing.assert_allclose(so[name], st[name], rtol=rtol,
                                   atol=1e-12 * scale + 1e-300,
                                   err_msg=f"sinks.{name}")
    return ours, theirs


def _spread_base(jstate, jcfg, factor):
    """`factor` x the tightest live candidate of a primed JAX state: the
    base dt that sends that particle `log2(factor)` rungs down."""
    cand = np.asarray(jax_candidates(jstate.particles, jcfg))
    return float(factor * cand[np.asarray(jstate.particles.alive)].min())


def _primed_pair(kw, ic, factor, jax_ic=jax_disc_ic, port_ic=disc_ic):
    """(JAX cfg, primed JAX state, port cfg, primed port state), both with
    dt set to `factor` x the tightest candidate, and the rungs that gives,
    equal on both sides."""
    import jax.numpy as jnp

    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    j0 = jax_prime(jax_ic(cfg=jcfg, **ic)[0], jcfg)
    base = _spread_base(j0, jcfg, factor)
    j0 = j0.replace(dt=jnp.asarray(base, j0.dt.dtype))
    t0 = prime(port_ic(cfg=cfg, device="cpu", **ic)[0], cfg)
    t0 = t0.replace(dt=torch.tensor(base, dtype=t0.dt.dtype))
    rung = blockstep.assign_rungs(t0.particles, cfg, t0.dt).numpy()
    jrung = np.asarray(jax_blockstep.assign_rungs(j0.particles, jcfg, j0.dt))
    np.testing.assert_array_equal(
        rung[np.argsort(t0.particles.pid.numpy())],
        jrung[np.argsort(np.asarray(j0.particles.pid))])
    return jcfg, j0, cfg, t0, rung[t0.particles.alive.numpy()]


# ------------------------------------------- fixed h, gravity none, B = 3

@pytest.fixture(scope="module")
def disc_runs():
    """tests/test_blockstep.py's `_disc` (m_star = 1) at N = 768 with three
    rungs, base dt 4x the tightest candidate; states after 1 and 2 base
    steps.  dt_min and dt_max stay wide, so the controller (cand_scale)
    is free to move dt."""
    kw = dict(fixed_h=2.0, gravity="none", neighbor_mode="sorted",
              use_pallas=False, sorted_block=128, window_group=32,
              window_blocks=4, dt_init=1e-5, dt_min=1e-9, dt_max=1e-2,
              dt_bins=3, dtype="float64")
    ic = dict(n=768, r_max=10.0, m_disc=1.0, m_star=1.0, u0=0.1, h0=2.0,
              seed=3)
    jcfg, j0, cfg, t0, rung = _primed_pair(kw, ic, 4.0)
    assert rung.max() == 2 and rung.min() == 0    # a real spread
    cuda_pairs.density_sums.gated_launches = 0
    j1 = jax_run_steps(j0, jcfg, 1)
    j2 = jax_run_steps(j1, jcfg, 1)
    t1 = run_steps(t0, cfg, 1)
    t2 = run_steps(t1, cfg, 1)
    return {"1": (t1, j1), "2": (t2, j2), "start": (t0, j0)}


@pytest.mark.parametrize("n_steps,rtol", [("1", 1e-9), ("2", 1e-7)])
def test_binned_disc_matches_jax(disc_runs, n_steps, rtol):
    ours, theirs = _compare(*disc_runs[n_steps], rtol)
    t0 = disc_runs["start"][0]
    if n_steps == "1":
        np.testing.assert_allclose(ours["t"], float(t0.t) + float(t0.dt),
                                   rtol=1e-12)
        # the candidate bound is relaxed by cand_scale = 4: without it the
        # controller would cut dt to the tightest candidate, base / 4
        assert ours["dt"] > 0.5 * float(t0.dt)
    check_health(disc_runs[n_steps][0])
    # the CPU takes the plain versions: no kernel launch was counted
    assert cuda_pairs.density_sums.gated_launches == 0


# ------------------------- variable h, a central sink, accretion, B = 2

def test_binned_variable_h_and_sinks_match_jax():
    """tests/test_blockstep.py's variable-h disc through `run_steps`: the
    gated h-iteration, sink creation off, accretion onto the central sink,
    two base steps of two substeps."""
    kw = dict(fixed_h=None, eta=1.2, h_iter_max=2, gravity="none",
              neighbor_mode="sorted", use_pallas=False, sorted_block=128,
              window_group=32, window_blocks=4, dt_init=2e-4, dt_min=1e-9,
              dt_max=1e-2, dt_bins=2, kahan_u=True, dtype="float64")
    ic = dict(n=512, r_max=10.0, m_disc=1.0, m_star=1.0, u0=0.1, seed=1)
    jcfg, j0, cfg, t0, rung = _primed_pair(kw, ic, 2.0)
    assert set(rung.tolist()) == {0, 1}
    out, jout = run_steps(t0, cfg, 2), jax_run_steps(j0, jcfg, 2)
    ours, _ = _compare(out, jout, 1e-7, extra=("omega",))
    assert out.particles.u_c is not None            # the Kahan carry rode
    m0 = float(t0.particles.mass.sum() + t0.sinks.mass.sum())
    m1 = float(out.particles.mass[out.particles.alive].sum()
               + out.sinks.mass.sum())
    assert m1 == pytest.approx(m0, rel=1e-12)
    assert ours["stats"][5] == 0                    # nonfinite


# ----------------------------- separate TreePM, far field held, B = 2

def test_binned_separate_treepm_holds_the_far_field_like_jax():
    """tests/test_pm_every.py's rigid-rotating cloud with dt_bins = 2 and
    pm_every = 2: three base steps solve the mesh at the first substep of
    base steps 0 and 2 and hold it through every other substep."""
    kw = dict(fixed_h=18.0, gravity="pm", grav_grid=32, grav_fft="xla",
              neighbor_mode="sorted", use_pallas=False, sorted_block=128,
              window_group=32, window_blocks=3, grav_window_blocks=3,
              gamma=1.4, bounding_size=1500.0, sink_capacity=4,
              dt_init=2e-4, dt_min=1e-6, dt_max=1e-3, pm_every=2,
              dt_bins=2, dtype="float64")
    ic = dict(n=384, r_max=50.0, m_disc=20.0, m_star=1.0, h0=18.0,
              rotation="rigidbody", v_circ=2.0, sink_capacity=4, seed=7)
    jcfg, j0, cfg, t0, rung = _primed_pair(kw, ic, 2.0)
    assert set(rung.tolist()) == {0, 1}
    pm_gravity.pm_long_range.solves = 0
    out, jout = run_steps(t0, cfg, 3), jax_run_steps(j0, jcfg, 3)
    assert pm_gravity.pm_long_range.solves == 2
    ours, theirs = _compare(out, jout, 1e-7, extra=("acc_ext",))
    np.testing.assert_allclose(ours["pm_r_s"], theirs["pm_r_s"], rtol=1e-12)
    assert float(ours["pm_r_s"]) > 0.0


# ------------------------- fused short range (Pallas interpret), B = 2

def test_binned_fused_treepm_matches_jax_interpret():
    """grav_fuse_short with dt_bins = 2 and pm_every = 2 on
    tests/test_gravity.py's jittered lattice with a sink: the JAX engine
    runs its gated Pallas kernels in interpret mode (its XLA engine has no
    fused form), one solved base step and one held."""
    import jax
    import jax.numpy as jnp
    from summersph_tpu.state import SimState as JSimState
    from summersph_tpu.state import Sinks as JSinks
    from test_density_forces import lattice_particles

    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.2))
    js = JSinks.create(pos=[[3.5, 3.5, 3.5]], vel=np.zeros((1, 3)),
                       mass=[0.5], radius=[0.3], capacity=2,
                       dtype=jnp.float64)
    jst = JSimState.create(jp, js, dt=1e-3)
    kw = dict(fixed_h=1.3, gravity="pm", grav_grid=32,
              neighbor_mode="sorted", use_pallas=True, sorted_block=128,
              window_group=128, window_blocks=5, pallas_window=640,
              pallas_fetch_window=768, grav_fuse_short=True, pm_every=2,
              dt_bins=2, dtype="float64", dt_init=1e-3, dt_min=1e-6,
              dt_max=1e-2, bounding_size=1500.0)

    def jax_ic(cfg, **_):
        return jst, None

    def port_ic(cfg, device, **_):
        return tstate.from_numpy(jax_state_dict(jst), device=device), None

    jcfg, j0, cfg, t0, rung = _primed_pair(
        dict(kw, pallas_interpret=True), {}, 2.0, jax_ic, port_ic)
    assert set(rung.tolist()) == {0, 1}
    pm_gravity.pm_long_range.solves = 0
    out, jout = run_steps(t0, cfg, 2), jax_run_steps(j0, jcfg, 2)
    assert pm_gravity.pm_long_range.solves == 1
    ours, theirs = _compare(out, jout, 1e-7, extra=("acc_ext",))
    np.testing.assert_allclose(ours["pm_r_s"], theirs["pm_r_s"], rtol=1e-12)
