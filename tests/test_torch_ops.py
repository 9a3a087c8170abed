"""The port's element-wise and leaf-level operators against the JAX
package's, on identical float64 inputs made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.ops import eos as jeos
from summersph_tpu.ops import gravity as jgravity
from summersph_tpu.ops import kernels as jkernels
from summersph_tpu.ops import pairs as jpairs
from summersph_tpu.ops import sinks as jsinks
from summersph_tpu.ops import timestep as jtimestep
from summersph_tpu.state import Particles as JParticles
from summersph_tpu.state import SimState as JSimState
from summersph_tpu.state import Sinks as JSinks
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops import eos, gravity, kernels, pairs, sinks
from summersph_tpu_torch.ops import timestep

from test_torch_config_state import jax_state_dict


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, rtol, err_msg=""):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=rtol,
                               atol=0.0, err_msg=err_msg)


def _state(n=96, n_sinks=3, sink_cap=4, seed=0, dead_every=7):
    """Matching JAX and port states: n particles in a 20 AU box with every
    field set from the seed, dead particles every `dead_every` slots, and
    n_sinks live sinks in sink_cap slots."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10.0, 10.0, (n, 3))
    jp = JParticles.create(pos=pos, vel=rng.normal(0, 2.0, (n, 3)),
                           mass=rng.uniform(0.5, 1.5, n) / n,
                           u=rng.uniform(-0.1, 2.0, n),
                           alpha=rng.uniform(0.1, 1.0, n),
                           h=rng.uniform(0.8, 1.6, n), dtype=jnp.float64)
    alive = np.arange(n) % dead_every != 0
    jp = jp.replace(
        alive=jnp.asarray(alive),
        acc=jnp.asarray(rng.normal(0, 5.0, (n, 3))),
        du=jnp.asarray(rng.normal(0, 1.0, n)),
        dalpha=jnp.asarray(rng.normal(0, 1.0, n)),
        rho=jnp.asarray(rng.uniform(0.5, 2.0, n)),
        pressure=jnp.asarray(rng.uniform(0.1, 1.0, n)),
        cs=jnp.asarray(rng.uniform(0.5, 1.5, n)))
    js = JSinks.create(pos=rng.uniform(-6.0, 6.0, (n_sinks, 3)),
                       vel=rng.normal(0, 1.0, (n_sinks, 3)),
                       mass=rng.uniform(1.0, 3.0, n_sinks),
                       radius=rng.uniform(2.0, 4.0, n_sinks),
                       capacity=sink_cap, dtype=jnp.float64)
    jstate = JSimState.create(jp, js, dt=1e-3)
    return jstate, tstate.from_numpy(jax_state_dict(jstate))


def _compare_trees(ours, theirs, rtol):
    d_o = tstate.to_numpy(ours)
    d_t = jax_state_dict(theirs)
    for group in ("particles", "sinks"):
        for name, a in d_t[group].items():
            if a.dtype.kind == "f":
                np.testing.assert_allclose(d_o[group][name], a, rtol=rtol,
                                           atol=0.0,
                                           err_msg=f"{group}.{name}")
            else:
                np.testing.assert_array_equal(d_o[group][name], a,
                                              err_msg=f"{group}.{name}")


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("name", ["w_shape", "dw_shape", "grav_shape"])
def test_shape_functions(name):
    q = np.concatenate([np.linspace(0.0, 2.5, 1001), [1.0, 2.0]])
    _close(getattr(kernels, name)(_t(q)), getattr(jkernels, name)(q), 1e-12)


@pytest.mark.parametrize("name", ["kernel_w", "kernel_dw", "kernel_dwdh",
                                  "grav_softening"])
def test_kernels_of_r_and_h(name):
    rng = np.random.default_rng(1)
    r = rng.uniform(0.0, 3.0, 500)
    h = rng.uniform(0.5, 2.0, 500)
    _close(getattr(kernels, name)(_t(r), _t(h)),
           getattr(jkernels, name)(r, h), 1e-12)


def test_kernel_w_dw():
    rng = np.random.default_rng(2)
    r = rng.uniform(0.0, 3.0, 500)
    h = rng.uniform(0.5, 2.0, 500)
    for ours, theirs in zip(kernels.kernel_w_dw(_t(r), _t(h)),
                            jkernels.kernel_w_dw(r, h)):
        _close(ours, theirs, 1e-12)


# ------------------------------------------------------------------ pairs

def _pair_inputs(seed=3, rows=6, cands=40):
    rng = np.random.default_rng(seed)
    d = {k: rng.normal(0.0, 1.0, (rows, cands)) for k in
         ("dxx", "dxy", "dxz", "vx", "vy", "vz")}
    for k in ("dxx", "dxy", "dxz"):
        d[k][:, 0] = 0.0          # a self lane in every row
    d["mask"] = rng.random((rows, cands)) < 0.8
    d["m_j"] = rng.uniform(0.5, 1.5, (rows, cands))
    for side, shape in (("_i", (rows, 1)), ("_j", (rows, cands))):
        d["h" + side] = rng.uniform(0.9, 1.6, shape)
        d["p" + side] = rng.uniform(0.1, 1.0, shape)
        d["rho" + side] = rng.uniform(0.5, 2.0, shape)
        d["om" + side] = rng.uniform(0.8, 1.2, shape)
        d["cs" + side] = rng.uniform(0.5, 1.5, shape)
        d["al" + side] = rng.uniform(0.1, 1.0, shape)
    return d


def test_pairs_density_sums():
    d = _pair_inputs()
    args = [d[k] for k in ("dxx", "dxy", "dxz", "h_i", "m_j", "mask")]
    for ours, theirs in zip(pairs.density_sums(*map(_t, args)),
                            jpairs.density_sums(*args)):
        _close(ours, theirs, 1e-12)


def test_pairs_finalize_density():
    rng = np.random.default_rng(4)
    n = 64
    rho = rng.uniform(0.0, 2.0, n)
    rho[:4] = 0.0
    om_raw = rng.normal(0.0, 1.0, n)
    om_raw[4:8] = -3.0 * rho[4:8] / rng.uniform(0.9, 1.6, 4)  # Omega ~ 0
    h = rng.uniform(0.9, 1.6, n)
    alive = rng.random(n) < 0.8
    m = rng.uniform(0.0, 1.0, n)
    m[:2] = 0.0
    args = (rho, om_raw, h, alive, m)
    for ours, theirs in zip(pairs.finalize_density(*map(_t, args)),
                            jpairs.finalize_density(*args)):
        _close(ours, theirs, 1e-12)


def test_pairs_force_sums_and_alpha_rate():
    d = _pair_inputs(seed=5)
    keys = ("dxx", "dxy", "dxz", "vx", "vy", "vz", "h_i", "h_j", "p_i",
            "p_j", "rho_i", "rho_j", "om_i", "om_j", "cs_i", "cs_j", "al_i",
            "al_j", "m_j", "mask")
    args = [d[k] for k in keys]
    cfg, jcfg = SimConfig(), JaxConfig()
    ours = pairs.force_sums(*map(_t, args), cfg)
    theirs = jpairs.force_sums(*args, jcfg)
    for o, t in zip(ours, theirs):
        _close(o, t, 1e-12)

    rng = np.random.default_rng(6)
    araw = np.asarray(theirs[4])
    rho = rng.uniform(0.0, 2.0, araw.shape)
    rho[0] = 0.0
    rest = [rng.uniform(0.1, 1.5, araw.shape) for _ in range(3)]
    _close(pairs.alpha_rate(_t(araw), _t(rho), *map(_t, rest), cfg),
           jpairs.alpha_rate(araw, rho, *rest, jcfg), 1e-12)


def test_eos_update():
    jst, st = _state(seed=7)
    cfg, jcfg = SimConfig(gamma=5.0 / 3.0), JaxConfig(gamma=5.0 / 3.0)
    ours = eos.eos_update(st.particles, cfg)
    theirs = jeos.eos_update(jst.particles, jcfg)
    _close(ours.pressure, theirs.pressure, 1e-12)
    _close(ours.cs, theirs.cs, 1e-12)


# --------------------------------------------------------------- timestep

@pytest.mark.parametrize("bound", [True, False])
@pytest.mark.parametrize("case", ["grow", "grow_capped", "hold_high",
                                  "hold_low", "shrink", "shrink_floored"])
def test_next_timestep_hysteresis_branches(case, bound):
    jst, _ = _state(seed=8)
    jp = jst.particles
    jst = jst.replace(particles=jp.replace(u=jnp.abs(jp.u)))
    st = tstate.from_numpy(jax_state_dict(jst))
    jcfg = JaxConfig(dt_bound_candidate=bound)
    cand = float(jnp.min(jtimestep.dt_candidates(jst.particles, jcfg)))
    # dt relative to the candidate picks the branch; dt_max / dt_min are
    # placed on either side of the grown / shrunk value
    dt, kw = {
        "grow": (cand / 2.5, dict(dt_max=cand)),
        "grow_capped": (cand / 2.5, dict(dt_max=cand / 2.0)),
        "hold_high": (cand / 1.9, dict(dt_max=cand)),
        "hold_low": (cand * 1.9, dict(dt_min=cand / 10.0)),
        "shrink": (cand * 2.5, dict(dt_min=cand / 10.0)),
        "shrink_floored": (cand * 2.5, dict(dt_min=cand * 2.0)),
    }[case]
    jcfg = jcfg.with_(**kw)
    cfg = SimConfig(dt_bound_candidate=bound, **kw)
    _close(timestep.dt_candidates(st.particles, cfg),
           jtimestep.dt_candidates(jst.particles, jcfg), 1e-12)
    ours = timestep.next_timestep(
        st.particles, torch.tensor(dt, dtype=torch.float64), cfg)
    theirs = jtimestep.next_timestep(jst.particles, jnp.asarray(dt), jcfg)
    _close(ours, theirs, 1e-12, err_msg=case)


# ----------------------------------------------------------- sinks, bounds

def test_sink_gravity():
    jst, st = _state(seed=9)
    for ours, theirs in zip(gravity.sink_gravity(st.particles, st.sinks),
                            jgravity.sink_gravity(jst.particles, jst.sinks)):
        _close(ours, theirs, 1e-10)


def test_accrete_with_a_particle_inside_two_sinks():
    jst, _ = _state(seed=10)
    # sinks 0 and 1 overlap around particle 1; particle 1 is nearer sink 1
    js = jst.sinks
    jp = jst.particles
    x1 = np.asarray(jp.pos[1])
    sp = np.asarray(js.pos).copy()
    sp[0] = x1 + [1.5, 0.0, 0.0]
    sp[1] = x1 - [0.0, 1.0, 0.0]
    js = js.replace(pos=jnp.asarray(sp), radius=jnp.asarray([2.0, 2.0, 3.0,
                                                             0.0]))
    jst = jst.replace(sinks=js)
    st = tstate.from_numpy(jax_state_dict(jst))
    jp2, js2 = jsinks.accrete(jst.particles, jst.sinks)
    p2, s2 = sinks.accrete(st.particles, st.sinks)
    assert bool(jp2.alive[1]) is False
    assert int(jnp.sum(jst.particles.alive) - jnp.sum(jp2.alive)) > 1
    _compare_trees(st.replace(particles=p2, sinks=s2),
                   jst.replace(particles=jp2, sinks=js2), 1e-10)


def test_cull_bounds():
    jst, _ = _state(seed=11)
    jp = jst.particles
    pos = np.asarray(jp.pos).copy()
    pos[3] = [0.0, 9.5, 0.0]      # beyond a 9 AU box
    pos[5] = [-9.8, 0.0, 1.0]
    jst = jst.replace(particles=jp.replace(pos=jnp.asarray(pos)))
    sp = np.asarray(jst.sinks.pos).copy()
    sp[2] = [0.0, 0.0, -20.0]
    jst = jst.replace(sinks=jst.sinks.replace(pos=jnp.asarray(sp)))
    st = tstate.from_numpy(jax_state_dict(jst))
    jcfg, cfg = JaxConfig(bounding_size=9.0), SimConfig(bounding_size=9.0)
    jp2, js2 = jsinks.cull_bounds(jst.particles, jst.sinks, jcfg)
    p2, s2 = sinks.cull_bounds(st.particles, st.sinks, cfg)
    assert not bool(jp2.alive[3]) and not bool(js2.alive[2])
    _compare_trees(st.replace(particles=p2, sinks=s2),
                   jst.replace(particles=jp2, sinks=js2), 1e-10)
