"""The port's `sort_particles` against the JAX package's on a jittered
lattice with dead particles, padding and one live outlier past the key
window.  Keys and windows must be identical; fields are compared per pid
(the JAX sort is unstable)."""

import jax.numpy as jnp
import numpy as np
import pytest

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
from summersph_tpu.state import PARK_POSITION
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops.sorted_grid import sort_particles

from test_density_forces import lattice_particles
from test_torch_config_state import port_particles


def _lattice(dtype):
    p = lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.25,
                          capacity=600)
    n = p.capacity
    pos = np.asarray(p.pos).copy()
    pos[7] = [5000.0, 3.0, 3.0]                   # beyond 1024 cells in x
    alive = np.asarray(p.alive) & (np.arange(n) % 5 != 1)
    pos[~alive] = PARK_POSITION
    p = p.replace(pos=jnp.asarray(pos), alive=jnp.asarray(alive),
                  mass=jnp.where(jnp.asarray(alive), p.mass, 0.0))
    return p.replace(**{f: getattr(p, f).astype(dtype) for f in
                        ("pos", "vel", "acc", "mass", "u", "rho",
                         "pressure", "cs", "du", "alpha", "dalpha", "h",
                         "omega")})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sort_particles_matches_jax(dtype):
    kw = dict(fixed_h=1.3, neighbor_mode="sorted", sorted_block=128,
              window_group=32)
    jp = _lattice(jnp.dtype(dtype))
    jp2, jgrid = jax_sort(jp, JaxConfig(**kw))
    p2, grid = sort_particles(port_particles(jp), SimConfig(**kw))

    assert grid.key.shape == (640,) and int(grid.n_clamped) >= 1
    for name in ("key", "starts", "ends", "n_clamped", "origin",
                 "cell_size"):
        np.testing.assert_array_equal(getattr(grid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)),
                                      err_msg=name)
    ours = tstate.to_numpy(tstate.SimState.create(p2, tstate.Sinks.zeros(1)))
    ours = ours["particles"]
    oo = np.argsort(ours["pid"])
    ot = np.argsort(np.asarray(jp2.pid))
    for name, a in ours.items():
        np.testing.assert_array_equal(
            a[oo], np.asarray(getattr(jp2, name))[ot], err_msg=name)


def test_window_group_must_tile_the_block():
    p = port_particles(_lattice(jnp.float32))
    with pytest.raises(ValueError):
        sort_particles(p, SimConfig(fixed_h=1.3, sorted_block=128,
                                    window_group=48))
