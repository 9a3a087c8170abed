"""The variable-h self-gravitating collapse (graded config 5,
`scripts/config5_run.py` build()) through the port's entry points against
the JAX package: the collapse initial state, then prime + 1 and prime + 10
steps at N = 2048, in float64 on the CPU.

The configuration is config 5's (variable h with three Newton iterations,
TreePM with the separate short range and pm_every 4, gamma 1.1, 128 sink
slots, sink merging, the Kahan u carry) with N cut to 2048, h0 scaled as
config 5 scales it, the mesh cut to 32^3 and the JAX side on its XLA
sorted engine (use_pallas=False) with windows that cover every candidate.
Both sides advance in one-step `run_steps` segments, so the far field is
solved on every step on both (the held far field is
test_torch_gravity_integrate's).  Every stats slot must be equal, the
h-iteration's `h_unconverged` and the rim's `sph_clamped` included.
Comparisons are per pid: the JAX sort is unstable.
"""

import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.integrate import prime as jax_prime
from summersph_tpu.integrate import run_steps as jax_run_steps
from summersph_tpu.models.disc import collapse_ic as jax_collapse_ic
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import (check_health, prime, run_steps,
                                           warn_stats)
from summersph_tpu_torch.models.disc import collapse_ic

from test_torch_config_state import jax_state_dict

N = 2048
H0 = (1_048_576 / N) ** (1.0 / 3.0)   # config 5's h0 scaling


def config5_kw(**extra):
    """scripts/config5_run.py's build() config at N, float64, on the XLA
    sorted engine (window_blocks 5 and grav_window_blocks 4 cover every
    SPH and gravity candidate at N = 2048)."""
    return dict(fixed_h=None, eta=1.2, h_iter_max=3,
                convergence_criteria=1e-3, max_length=1.5 * H0,
                cell_h_quantile=0.9, gravity="pm", grav_grid=32, theta=0.5,
                grav_fft="xla", neighbor_mode="sorted", use_pallas=False,
                sorted_block=128, window_group=32, window_blocks=5,
                grav_window_blocks=4, gamma=1.1, bounding_size=1500.0,
                sink_capacity=128, sink_merge_factor=1.0, kahan_u=True,
                pm_every=4, dt_init=1e-4, dt_min=1e-7, dt_max=5e-3,
                dtype="float64", **extra)


def collapse_state(pkg_collapse_ic, cfg):
    """config 5's initial conditions at N in either package."""
    kw = {"device": "cpu"} if pkg_collapse_ic is collapse_ic else {}
    return pkg_collapse_ic(n=N, r_max=50.0, m_total=50.0, u0=0.25,
                           rotation="rigidbody", v_circ=4.2, h0=H0, cfg=cfg,
                           seed=0, **kw)[0]


def run_both(jcfg, cfg, jst, st):
    """(port states, JAX state dicts) after prime + 1 and prime + 10 steps,
    both in one-step segments, the 10-step stats the running maximum."""
    j = jax_run_steps(jax_prime(jst, jcfg), jcfg, 1)
    t = run_steps(prime(st, cfg), cfg, 1)
    ours, theirs = {"1": t}, {"1": jax_state_dict(j)}
    j_max, t_max = np.asarray(j.stats), t.stats
    for _ in range(9):
        j = jax_run_steps(j, jcfg, 1)
        t = run_steps(t, cfg, 1)
        j_max = np.maximum(j_max, np.asarray(j.stats))
        t_max = torch.maximum(t_max, t.stats)
    ours["10"] = t.replace(stats=t_max)
    theirs["10"] = jax_state_dict(j)
    theirs["10"]["stats"] = j_max
    return ours, theirs


def compare(ours, theirs, rtol):
    """t, dt, every stats slot, the particles per pid and every sink field
    of a port state against a JAX state dict."""
    ours = tstate.to_numpy(ours)
    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-12)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    po, pt = ours["particles"], theirs["particles"]
    oo, ot = np.argsort(po["pid"]), np.argsort(pt["pid"])
    np.testing.assert_array_equal(po["alive"][oo], pt["alive"][ot])
    for name in ("pos", "vel", "u", "rho", "h", "omega", "acc", "mass"):
        np.testing.assert_allclose(po[name][oo], pt[name][ot], rtol=rtol,
                                   atol=1e-300, err_msg=name)
    so, st = ours["sinks"], theirs["sinks"]
    np.testing.assert_array_equal(so["alive"], st["alive"])
    for name in ("pos", "vel", "acc", "spin", "mass", "radius"):
        scale = np.abs(st[name]).max()
        np.testing.assert_allclose(so[name], st[name], rtol=rtol,
                                   atol=1e-12 * scale + 1e-300,
                                   err_msg=f"sinks.{name}")


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = JaxConfig(**config5_kw()), SimConfig(**config5_kw())
    return run_both(jcfg, cfg, collapse_state(jax_collapse_ic, jcfg),
                    collapse_state(collapse_ic, cfg))


def test_collapse_ic_matches_jax_exactly():
    cfg = SimConfig(**config5_kw())
    ours = tstate.to_numpy(collapse_state(collapse_ic, cfg))
    theirs = jax_state_dict(collapse_state(jax_collapse_ic,
                                           JaxConfig(**config5_kw())))
    for group in ("particles", "sinks"):
        assert ours[group].keys() == theirs[group].keys()
        for name, a in theirs[group].items():
            np.testing.assert_array_equal(ours[group][name], a,
                                          err_msg=f"{group}.{name}")
    # a zero-mass dummy sink at the origin, as the JAX reader plants
    assert ours["sinks"]["alive"][0] and ours["sinks"]["mass"][0] == 0.0


@pytest.mark.parametrize("n_steps,rtol", [("1", 1e-9), ("10", 1e-7)])
def test_collapse_steps_match_jax(runs, n_steps, rtol):
    compare(runs[0][n_steps], runs[1][n_steps], rtol)


def test_collapse_counters_and_health(runs):
    """The h-iteration leaves particles unconverged and the rim's 2h
    outgrows the 0.9-quantile cell (both counted, as in the JAX package);
    nothing else trips."""
    st = runs[0]["10"]
    d = st.stats_dict()
    assert d["h_unconverged"] > 0 and d["sph_clamped"] > 0
    assert not any(v for k, v in d.items()
                   if k not in ("h_unconverged", "sph_clamped"))
    check_health(st)
    assert warn_stats(st) is True        # sph_clamped is a warning
    assert int(st.particles.n_alive) == N
