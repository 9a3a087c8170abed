"""The port's config and state against the JAX package's: the same fields
and defaults, an exact numpy round trip, and no jax import."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.models.disc import disc_ic as jax_disc_ic
from summersph_tpu.state import STATS_FIELDS as JAX_STATS_FIELDS
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig

REPO = Path(__file__).resolve().parent.parent

# Under pytest-xdist each worker gets its share of the cores for torch's
# intra-op threads.  Left at all the cores each, six workers' OpenMP threads
# spin against each other and a small CPU op runs about 15x slower.  Every
# worker imports every test module when it collects, so this one call sets
# them all; the port's other test files import this module too.
torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def jax_state_dict(state) -> dict:
    """A JAX SimState as the nested numpy dict `from_numpy` takes."""
    def tree(t):
        return {f.name: np.asarray(getattr(t, f.name))
                for f in dataclasses.fields(t)
                if getattr(t, f.name) is not None}

    out = {"particles": tree(state.particles), "sinks": tree(state.sinks),
           "t": np.asarray(state.t), "dt": np.asarray(state.dt),
           "stats": np.asarray(state.stats)}
    if state.pm_r_s is not None:
        out["pm_r_s"] = np.asarray(state.pm_r_s)
    return out


def port_particles(jp):
    """JAX Particles as port Particles (CPU), through the numpy bridge."""
    from summersph_tpu.state import SimState, Sinks
    jstate = SimState.create(jp, Sinks.zeros(1, jp.pos.dtype))
    return tstate.from_numpy(jax_state_dict(jstate), device="cpu").particles


def test_config_fields_and_defaults_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(SimConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    cfg = SimConfig(theta=0.3)
    assert cfg.effective_rcut_rs() == JaxConfig(theta=0.3).effective_rcut_rs()
    assert cfg.with_(dtype="float64").np_dtype() == torch.float64
    assert cfg.np_dtype() == torch.float32
    assert tstate.STATS_FIELDS == JAX_STATS_FIELDS


@pytest.mark.parametrize("carries", ["none", "kahan_and_pm"])
def test_numpy_round_trip_of_a_jax_state_is_exact(carries):
    jstate, _ = jax_disc_ic(n=300, capacity=384, seed=3,
                            cfg=JaxConfig(fixed_h=2.0, dtype="float64"))
    if carries == "kahan_and_pm":
        import jax.numpy as jnp
        p = jstate.particles
        jstate = jstate.replace(
            particles=p.replace(u_c=jnp.full_like(p.u, 1e-9),
                                acc_ext=jnp.ones_like(p.pos)),
            pm_r_s=jnp.asarray(0.5))
    d = jax_state_dict(jstate)
    ours = tstate.from_numpy(d, device="cpu")
    back = tstate.to_numpy(ours)
    assert back.keys() == d.keys()
    for group in ("particles", "sinks"):
        assert back[group].keys() == d[group].keys()
        for name, a in d[group].items():
            assert back[group][name].dtype == a.dtype, (group, name)
            np.testing.assert_array_equal(back[group][name], a,
                                          err_msg=f"{group}.{name}")
    for name in ("t", "dt", "stats", "pm_r_s"):
        if name in d:
            np.testing.assert_array_equal(back[name], d[name])
    assert ours.particles.capacity == 384
    assert int(ours.particles.n_alive) == 300


def test_import_leaves_jax_out():
    code = ("import sys; before = set(sys.modules);"
            " import summersph_tpu_torch, summersph_tpu_torch.integrate,"
            " summersph_tpu_torch.diagnostics, summersph_tpu_torch.models,"
            " summersph_tpu_torch.io, summersph_tpu_torch.tools,"
            " summersph_tpu_torch.cli, summersph_tpu_torch.models.sod;"
            " bad = [m for m in set(sys.modules) - before"
            " if m.split('.')[0] in ('jax', 'flax', 'summersph_tpu')];"
            " print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_the_card():
    """disc_ic, collapse_ic, the state constructors and from_numpy put their
    tensors on the card unless the caller names another device; without a
    card that default raises instead of moving to the CPU."""
    import inspect

    from summersph_tpu_torch.models.disc import collapse_ic, disc_ic

    for fn in (disc_ic, collapse_ic, tstate.Particles.zeros,
               tstate.Particles.create, tstate.Sinks.zeros,
               tstate.Sinks.create, tstate.from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        st, _ = disc_ic(n=64)
        assert st.particles.pos.is_cuda and st.t.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            disc_ic(n=64)
        with pytest.raises((RuntimeError, AssertionError)):
            tstate.Particles.zeros(8)
