"""The variable-h (grad-h) pair passes of `ops/cuda_pairs.py` against the
JAX package: the plain versions of `density_var_h`, `force_var_h` and
`force_var_h_grav`, which the wrappers take on the CPU.

Held against the Pallas kernels with fixed_h=None in interpret mode (f32,
tests/test_pallas.py's tolerances; the fused form in f64) and against the
XLA sorted engine in f64, with and without dead particles, and on a
lattice whose h grows threefold along x, so that many pairs reach only
from their j side (r >= 2 h_i but r < 2 h_j): a pass that cut pairs at
2 h_i alone would lose their terms.  The JAX side drops nothing
(`window_overflow == 0`, `n_window_overflow == 0`); comparisons are per
pid, since the JAX sort is unstable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops import cuda_pairs
from summersph_tpu_torch.ops.sorted_grid import sort_particles

from test_density_forces import lattice_particles
from test_torch_config_state import port_particles

# tests/test_pallas.py's f32 tolerances
RHO_TOL = dict(rtol=2e-5, atol=1e-7)
FORCE_TOL = dict(rtol=2e-4, atol=1e-6)
FIELDS = ("rho", "omega", "acc", "du", "dalpha")


def _kw(**extra):
    return dict(fixed_h=None, neighbor_mode="sorted", sorted_block=128,
                window_blocks=5, pallas_window=640, use_pallas=True, **extra)


def _f64(p):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, p)


def _lattice(dead=False, gradient=False):
    """The JAX tests' jittered 8^3 lattice at h = 1.3; optionally every
    fourth particle dead, or h = 0.6 + 0.2 x (0.6 to about 2.1)."""
    from summersph_tpu.state import PARK_POSITION

    p = lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.25)
    if gradient:
        p = p.replace(h=0.6 + 0.2 * jnp.clip(p.pos[:, 0], 0.0, None))
    if dead:
        alive = jnp.arange(p.capacity) % 4 != 0
        p = p.replace(alive=alive, mass=jnp.where(alive, p.mass, 0.0),
                      pos=jnp.where(alive[:, None], p.pos, PARK_POSITION))
    return p


def _by_pid(pid, **arrays):
    order = np.argsort(np.asarray(pid))
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


def _port(jp, cfg, grav_split=None):
    """The port's pair pass (the plain versions) from unsorted JAX
    particles, per pid."""
    p2, grid = sort_particles(port_particles(jp), cfg)
    out = cuda_pairs.pair_eval(p2, cfg, grid, grav_split)
    p3 = out[0]
    arrays = dict(rho=p3.rho, omega=p3.omega, acc=out[1], du=out[2],
                  dalpha=out[3], alive=p3.alive)
    if grav_split is not None:
        arrays["acc_grav"] = out[4]
    return _by_pid(p3.pid.numpy(), **{k: v.numpy()
                                      for k, v in arrays.items()})


def _xla(jp, jcfg):
    """The JAX XLA sorted engine's density, EOS and forces, per pid."""
    from summersph_tpu.ops.eos import eos_update
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
    from summersph_tpu.ops.sorted_grid import sorted_density, sorted_forces

    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(jgrid.n_window_overflow) == 0
    jp3 = eos_update(sorted_density(jp2, jcfg, jgrid), jcfg)
    acc, du, dal = sorted_forces(jp3, jcfg, jgrid)
    return _by_pid(jp3.pid, rho=jp3.rho, omega=jp3.omega, acc=acc, du=du,
                   dalpha=dal, alive=jp3.alive)


def test_var_h_pair_eval_matches_pallas_interpret_f32():
    from summersph_tpu.ops.pallas_pairs import (pallas_pair_eval,
                                                window_overflow)
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort

    jp = _lattice()
    jcfg = JaxConfig(**_kw())
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(window_overflow(jgrid, jcfg)) == 0
    jp3, jacc, jdu, jdal = pallas_pair_eval(jp2, jcfg, jgrid, interpret=True)
    theirs = _by_pid(jp3.pid, rho=jp3.rho, omega=jp3.omega, acc=jacc,
                     du=jdu, dalpha=jdal)

    ours = _port(jp, SimConfig(**_kw()))
    assert ours["rho"].dtype == np.float32
    assert np.abs(ours["omega"] - 1.0).max() > 1e-3  # grad-h term is live
    np.testing.assert_allclose(ours["rho"], theirs["rho"], **RHO_TOL)
    for name in FIELDS[1:]:
        np.testing.assert_allclose(ours[name], theirs[name], **FORCE_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["uniform", "dead", "h_gradient"])
def test_var_h_pair_eval_matches_xla_sorted_engine_f64(case):
    jp = _f64(_lattice(dead=case == "dead", gradient=case == "h_gradient"))
    theirs = _xla(jp, JaxConfig(**_kw(dtype="float64")))
    ours = _port(jp, SimConfig(**_kw(dtype="float64")))
    assert ours["rho"].dtype == np.float64
    np.testing.assert_array_equal(ours["alive"], theirs["alive"])
    for name in FIELDS:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-9,
                                   atol=1e-13 * np.abs(theirs[name]).max(),
                                   err_msg=name)


def test_h_gradient_lattice_has_pairs_that_reach_only_from_j():
    """The gradient case above tests the j side only if many pairs lie in
    2 h_i <= r < 2 h_j, where dW(h_i) is 0 and dW(h_j) is not."""
    jp = _f64(_lattice(gradient=True))
    p = port_particles(jp)
    pos, h = p.pos[p.alive], p.h[p.alive]
    r = torch.cdist(pos, pos)
    j_only = (r >= 2.0 * h[:, None]) & (r < 2.0 * h[None, :])
    assert int(j_only.sum()) > 1000
    assert float(h.max() / h.min()) > 3.0


def test_fused_var_h_force_sums_match_pallas_interpret_f64():
    """tests/test_gravity.py's jittered lattice with fixed_h=None: the plain
    fused force sums (SPH and short-range gravity, the force_var_h_grav
    algebra) against `pallas_pair_eval` with grav_split in interpret mode,
    in float64."""
    from summersph_tpu.ops.pallas_pairs import (pallas_pair_eval,
                                                window_overflow)
    from summersph_tpu.ops.pm_gravity import pm_geometry as jax_geometry
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort

    kw = dict(fixed_h=None, gravity="pm", grav_grid=32,
              neighbor_mode="sorted", use_pallas=True, sorted_block=128,
              window_group=128, window_blocks=5, pallas_window=640,
              pallas_fetch_window=768, dtype="float64")
    jp = _f64(lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.2))
    jcfg = JaxConfig(**kw, pallas_interpret=True)
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(window_overflow(jgrid, jcfg)) == 0
    r_s = jax_geometry(jp2, jcfg)[2]
    r_cut = jcfg.effective_rcut_rs() * r_s
    assert float(r_cut) <= float(jgrid.cell_size)
    jout = pallas_pair_eval(jp2, jcfg, jgrid, interpret=True,
                            grav_split=(r_s, r_cut))
    theirs = _by_pid(jout[0].pid, rho=jout[0].rho, omega=jout[0].omega,
                     acc=jout[1], du=jout[2], dalpha=jout[3],
                     acc_grav=jout[4])

    split = tuple(torch.tensor(float(v), dtype=torch.float64)
                  for v in (r_s, r_cut))
    ours = _port(jp, SimConfig(**kw), split)
    assert np.abs(ours["acc_grav"]).max() > 0.0
    for name in FIELDS + ("acc_grav",):
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-9,
                                   atol=1e-12 * np.abs(theirs[name]).max(),
                                   err_msg=name)
