"""The dense O(N^2) engine of the port (`ops/density.py`, `ops/forces.py`,
`gas_gravity_direct(cols=)`, the dense h-iteration, `neighbor_mode=
'dense'` in `integrate`) against the JAX package's dense path with
grid=None, in float64, and against the port's own sorted engine, which
the dense pass exists to check.

Tolerances: tests/test_pallas.py's, rho rtol 2e-5 (atol 1e-7), Omega and
acc / du / dalpha rtol 2e-4 (atol 1e-6); whole steps as
tests/test_torch_integrate.py holds float64 steps, rtol 1e-9.  Inputs are
made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import prime, run_steps
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.ops import cuda_pairs
from summersph_tpu_torch.ops.density import compute_density
from summersph_tpu_torch.ops.eos import eos_update
from summersph_tpu_torch.ops.forces import compute_sph_forces
from summersph_tpu_torch.ops.gravity import gas_gravity_direct
from summersph_tpu_torch.ops.sorted_grid import sort_particles

from test_torch_config_state import jax_state_dict, port_particles

RHO_TOL = dict(rtol=2e-5, atol=1e-7)
OMEGA_TOL = dict(rtol=2e-4, atol=1e-6)
FORCE_TOL = dict(rtol=2e-4, atol=1e-6)
STEP_RTOL = 1e-9

N = 512
H_FIXED = 1.2


def _kw(var_h: bool, **extra):
    return dict(fixed_h=None if var_h else H_FIXED, neighbor_mode="dense",
                sorted_block=128, window_group=32, dtype="float64", **extra)


def _jax_cloud(var_h: bool, seed=5):
    """N particles in a jittered box (about one per unit volume), h from
    0.8 to 1.6 with variable h, every seventh particle dead and parked."""
    import jax.numpy as jnp
    from summersph_tpu.state import PARK_POSITION, Particles

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4.0, 4.0, (N, 3))
    h = rng.uniform(0.8, 1.6, N) if var_h else H_FIXED
    p = Particles.create(pos=pos, vel=rng.normal(0.0, 0.3, (N, 3)),
                         mass=rng.uniform(0.5, 1.5, N), u=rng.uniform(
                             0.2, 0.6, N), alpha=rng.uniform(0.1, 0.5, N),
                         h=h, dtype=jnp.float64)
    alive = jnp.arange(N) % 7 != 3
    return p.replace(alive=alive, mass=jnp.where(alive, p.mass, 0.0),
                     pos=jnp.where(alive[:, None], p.pos, PARK_POSITION))


def _jax_density(jp, jcfg):
    from summersph_tpu.ops.density import compute_density as jax_density
    from summersph_tpu.ops.eos import eos_update as jax_eos

    return jax_eos(jax_density(jp, jcfg), jcfg)


@pytest.mark.parametrize("var_h", [False, True])
def test_dense_density_matches_jax(var_h):
    from summersph_tpu.config import SimConfig as JaxConfig

    jp = _jax_cloud(var_h)
    theirs = _jax_density(jp, JaxConfig(**_kw(var_h)))
    ours = compute_density(port_particles(jp), SimConfig(**_kw(var_h)))
    np.testing.assert_allclose(ours.rho.numpy(), np.asarray(theirs.rho),
                               **RHO_TOL)
    np.testing.assert_allclose(ours.omega.numpy(), np.asarray(theirs.omega),
                               **OMEGA_TOL)


@pytest.mark.parametrize("var_h", [False, True])
def test_dense_forces_and_direct_gravity_match_jax(var_h):
    """compute_sph_forces on the JAX density's fields, and
    gas_gravity_direct on a third of the rows against every column."""
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops.forces import compute_sph_forces as jax_forces
    from summersph_tpu.ops.gravity import gas_gravity_direct as jax_direct
    import jax

    jcfg = JaxConfig(**_kw(var_h))
    jp = _jax_density(_jax_cloud(var_h), jcfg)
    p, cfg = port_particles(jp), SimConfig(**_kw(var_h))
    for ours, theirs, name in zip(compute_sph_forces(p, cfg),
                                  jax_forces(jp, jcfg),
                                  ("acc", "du", "dalpha")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   **FORCE_TOL, err_msg=name)
    k = N // 3
    jrows = jax.tree_util.tree_map(lambda a: a[:k], jp)
    ours = gas_gravity_direct(p.map(lambda a: a[:k]), cfg, cols=p)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jax_direct(jrows, jcfg, cols=jp)),
                               **FORCE_TOL)


@pytest.mark.parametrize("var_h", [False, True])
def test_dense_oracle_holds_the_sorted_plain_versions(var_h):
    """The sorted engine's plain versions (`density_sums_plain`,
    `force_sums_plain` through `cuda_pairs.density` / `forces`) against
    the dense sums, per pid: with the sort's cell at 2 h_max every pair
    inside 2 max(h_i, h_j) lies in the windows."""
    cfg = SimConfig(**_kw(var_h, cell_h_quantile=1.0))
    p = port_particles(_jax_cloud(var_h))
    dense = eos_update(compute_density(p, cfg), cfg)
    acc, du, dalpha = compute_sph_forces(dense, cfg)

    p2, grid = sort_particles(p, cfg)
    assert int(grid.n_clamped) == 0
    p2 = eos_update(cuda_pairs.density(p2, cfg, grid), cfg)
    s_acc, s_du, s_dalpha = cuda_pairs.forces(p2, cfg, grid)
    at = p2.pid.long()
    assert torch.equal(p2.alive, p.alive[at])
    np.testing.assert_allclose(p2.rho.numpy(), dense.rho[at].numpy(),
                               **RHO_TOL)
    np.testing.assert_allclose(p2.omega.numpy(), dense.omega[at].numpy(),
                               **OMEGA_TOL)
    for ours, theirs, name in ((s_acc, acc, "acc"), (s_du, du, "du"),
                               (s_dalpha, dalpha, "dalpha")):
        np.testing.assert_allclose(ours.numpy(), theirs[at].numpy(),
                                   **FORCE_TOL, err_msg=name)


def _disc_kw(var_h: bool):
    """A disc of 256 particles around a sink.  With variable h, h0 = 2
    lies far under the equilibrium h (about 15), so every step's
    iteration grows h up to the cap, 1.25 h_max, and direct gravity; the
    JAX package's hashed grid holds every particle in a cell
    (cell_cap = N)."""
    if var_h:
        return _kw(True, gravity="direct", cell_cap=256, h_iter_max=3,
                   dt_init=1e-4, bounding_size=1500.0)
    return _kw(False, gravity="none", dt_init=1e-4, bounding_size=1500.0)


@pytest.mark.parametrize("var_h", [False, True])
def test_dense_steps_match_jax(var_h):
    """prime + 3 steps with neighbor_mode='dense': positions, velocities,
    u, rho, h, the clock, the sinks and every health counter."""
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.integrate import prime as jax_prime
    from summersph_tpu.integrate import run_steps as jax_run_steps
    from summersph_tpu.models.disc import disc_ic as jax_disc_ic

    kw = _disc_kw(var_h)
    ic = dict(n=256, r_max=50.0, m_star=1.0, h0=2.0 if var_h else H_FIXED,
              rotation="keplerian", seed=4)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    theirs = jax_state_dict(jax_run_steps(
        jax_prime(jax_disc_ic(cfg=jcfg, **ic)[0], jcfg), jcfg, 3))
    ours = tstate.to_numpy(run_steps(prime(
        disc_ic(cfg=cfg, device="cpu", **ic)[0], cfg), cfg, 3))

    np.testing.assert_allclose(ours["t"], theirs["t"], rtol=1e-12)
    np.testing.assert_allclose(ours["dt"], theirs["dt"], rtol=1e-12)
    np.testing.assert_array_equal(ours["stats"], theirs["stats"])
    po, pt = ours["particles"], theirs["particles"]
    np.testing.assert_array_equal(po["pid"], pt["pid"])   # no sort
    np.testing.assert_array_equal(po["alive"], pt["alive"])
    for name in ("pos", "vel", "u", "rho", "h", "acc"):
        np.testing.assert_allclose(po[name], pt[name], rtol=STEP_RTOL,
                                   atol=1e-300, err_msg=name)
    for name in ("mass", "pos", "vel", "spin"):
        np.testing.assert_allclose(ours["sinks"][name], theirs["sinks"][name],
                                   rtol=STEP_RTOL, atol=1e-300, err_msg=name)
    if var_h:   # the cap was reached: h grew by exactly 1.25 a step
        h = po["h"][po["alive"]]
        assert np.isclose(h.max(), 2.0 * 1.25 ** 3, rtol=1e-12)
