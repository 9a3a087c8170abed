"""`ops/smoothing.py` and the sink lifecycle of `ops/sinks.py` against the
JAX package, in float64 on seeded inputs.

The h-iteration on its two sorted paths (the in-step shared grid, which
reuses the force pass's density, and the standalone path with its own
sort) against the JAX XLA sorted engine: h, rho and Omega at rtol 1e-9
and the unconverged count equal.  The Newton safeguards as
tests/test_smoothing.py checks them.  `create_sinks` near a real sink
(vetoed), at the zero-mass dummy sink (not vetoed) and with every slot
taken; `merge_sinks` on a chain that needs pointer jumping.  Every sink
field at rtol 1e-12.  Comparisons are per pid: the JAX sort is unstable.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.state import Particles as JParticles
from summersph_tpu.state import SimState as JSimState
from summersph_tpu.state import Sinks as JSinks
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops import cuda_pairs, sinks, smoothing
from summersph_tpu_torch.ops.sorted_grid import sort_particles

from test_density_forces import lattice_particles
from test_torch_config_state import jax_state_dict, port_particles

SINK_FIELDS = ("pos", "vel", "acc", "spin", "mass", "radius", "alive")


def _kw(**extra):
    return dict(fixed_h=None, eta=1.2, convergence_criteria=1e-4,
                h_iter_max=3, max_length=1.6, neighbor_mode="sorted",
                sorted_block=128, window_group=32, window_blocks=5,
                cell_h_quantile=0.9, dtype="float64", **extra)


def _off_target_lattice():
    """The 8^3 jittered lattice at unit mass (rho ~ 1) with h 30% above its
    eta scaling and a spread, so the iteration is still moving after
    three updates and some h reach the cap."""
    p = lattice_particles(nside=8, spacing=1.0, h=1.0, jitter=0.1)
    rng = np.random.default_rng(5)
    h = 1.56 * (1.0 + 0.1 * rng.standard_normal(p.capacity))
    return p.replace(mass=jnp.ones(p.capacity, jnp.float64),
                     h=jnp.asarray(h, jnp.float64),
                     pos=p.pos.astype(jnp.float64),
                     vel=p.vel.astype(jnp.float64),
                     u=p.u.astype(jnp.float64),
                     alpha=p.alpha.astype(jnp.float64))


def _per_pid(pid, **arrays):
    order = np.argsort(np.asarray(pid))
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


def _hold_smoothing(ours, n_ours, theirs, n_theirs):
    ours = _per_pid(ours.pid.numpy(), h=ours.h.numpy(), rho=ours.rho.numpy(),
                    omega=ours.omega.numpy(), alive=ours.alive.numpy())
    theirs = _per_pid(theirs.pid, h=theirs.h, rho=theirs.rho,
                      omega=theirs.omega, alive=theirs.alive)
    live = theirs["alive"]
    np.testing.assert_array_equal(ours["alive"], live)
    for name in ("h", "rho", "omega"):
        np.testing.assert_allclose(ours[name][live], theirs[name][live],
                                   rtol=1e-9, err_msg=name)
    assert int(n_ours) == int(n_theirs)
    return ours


def test_shared_grid_h_iteration_matches_jax():
    from summersph_tpu.ops.smoothing import update_smoothing
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
    from summersph_tpu.ops.sorted_grid import sorted_density

    jcfg, cfg = JaxConfig(**_kw()), SimConfig(**_kw())
    jp = _off_target_lattice()
    jp2, jgrid = jax_sort(jp, jcfg, h_pad=jcfg.sort_h_pad)
    assert int(jgrid.n_window_overflow) == 0
    jout, jn = update_smoothing(sorted_density(jp2, jcfg, jgrid), jcfg,
                                grid=jgrid)

    p2, grid = sort_particles(port_particles(jp), cfg, h_pad=cfg.sort_h_pad)
    n0 = cuda_pairs.density_sums.var_launches
    out, n = smoothing.update_smoothing(cuda_pairs.density(p2, cfg, grid),
                                        cfg, grid=grid)
    assert cuda_pairs.density_sums.var_launches == n0  # CPU: no launch
    ours = _hold_smoothing(out, n, jout, jn)
    assert 0 < int(n) < int(out.n_alive)
    assert np.any(ours["h"] == float(torch.clamp(grid.cell_size / 2.0,
                                                 max=cfg.max_length)))


def test_standalone_h_iteration_matches_jax():
    from summersph_tpu.ops.smoothing import update_smoothing

    jcfg, cfg = JaxConfig(**_kw()), SimConfig(**_kw())
    jp = _off_target_lattice()
    jout, jn = update_smoothing(jp, jcfg)
    out, n = smoothing.update_smoothing(port_particles(jp), cfg)
    _hold_smoothing(out, n, jout, jn)
    assert out.capacity == jp.capacity


def test_update_smoothing_refuses_unported_paths():
    cfg = SimConfig(**_kw())
    p = port_particles(_off_target_lattice())
    for kw in (dict(cols=p), dict(axis_name="dp"), dict(key_rows=p.pid)):
        with pytest.raises(NotImplementedError):
            smoothing.update_smoothing(p, cfg, **kw)
    with pytest.raises(NotImplementedError):
        smoothing.update_smoothing(p, cfg.with_(neighbor_mode="dense"))
    # 'grid' runs on the sorted engine: the same h, bit for bit
    out, n = smoothing.update_smoothing(p, cfg.with_(neighbor_mode="grid"))
    ref, n_ref = smoothing.update_smoothing(p, cfg)
    assert torch.equal(out.h, ref.h) and int(n) == int(n_ref)


def test_newton_safeguard_rim_omega():
    """tests/test_smoothing.py's rim cases on the port's `_newton`."""
    def newton(h, rho, omega, m, eta):
        return float(smoothing._newton(*(torch.tensor(v, dtype=torch.float64)
                                         for v in (h, rho, omega, m)), eta))

    h, m, eta = 5.0, 6.1e-3, 1.2
    target_rho = m * (eta / h) ** 3
    for omega in (1.0, 0.3, 0.01, -0.2, -5.0):
        h_new = newton(h, 0.6 * target_rho, omega, m, eta)
        assert h < h_new <= 2.0 * h, (omega, h_new)
    assert newton(h, 1e3 * target_rho, 0.2, m, eta) == 0.5 * h
    h_new = newton(h, 1e3 * target_rho, 1.0, m, eta)
    assert 0.5 * h < h_new < h


# ------------------------------------------------------------------ sinks

def _gas(n=96, seed=11):
    """Seeded gas in a 6 AU box with h in [0.3, 0.9]; m = 1."""
    rng = np.random.default_rng(seed)
    return JParticles.create(
        pos=rng.uniform(-3.0, 3.0, (n, 3)), vel=rng.normal(0, 0.5, (n, 3)),
        mass=np.ones(n), u=np.ones(n), h=rng.uniform(0.3, 0.9, n),
        capacity=128, dtype=jnp.float64)


def _sinks(pos, mass, radius, capacity=4, vel=None, seed=3):
    vel = (np.random.default_rng(seed).normal(0, 0.2, (len(pos), 3))
           if vel is None else vel)
    return JSinks.create(pos=pos, vel=vel, mass=mass, radius=radius,
                         capacity=capacity, dtype=jnp.float64)


def _both(jp, js):
    """(JAX state, port state) of the same particles and sinks."""
    jst = JSimState.create(jp, js)
    return jst, tstate.from_numpy(jax_state_dict(jst), device="cpu")


def _hold_sinks(ours, theirs):
    for name in SINK_FIELDS:
        a = getattr(ours, name).numpy()
        b = np.asarray(getattr(theirs, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300,
                                       err_msg=name)


def _create(jp, js, density):
    from summersph_tpu.ops.sinks import create_sinks as jax_create

    jst, st = _both(jp, js)
    jcfg = JaxConfig(fixed_h=None, eta=1.2, sink_create_density=density,
                     sink_create_mass=1e-6)
    cfg = SimConfig(fixed_h=None, eta=1.2, sink_create_density=density,
                    sink_create_mass=1e-6)
    js2, jfull = jax_create(jst.particles, jst.sinks, jcfg)
    s2, full = sinks.create_sinks(st.particles, st.sinks, cfg)
    _hold_sinks(s2, js2)
    assert full.dtype == torch.int32 and int(full) == int(jfull)
    return s2, int(full)


def _code_density(jp):
    return np.asarray(jp.mass * (1.2 / jp.h) ** 3)


def test_create_sinks_at_the_densest_eligible_particle():
    jp = _gas()
    cd = _code_density(jp)
    order = np.argsort(-cd[:96])
    # a real sink over the densest particle vetoes it; the next one wins
    best = np.asarray(jp.pos)[order[0]]
    js = _sinks([best, [50.0, 0, 0]], mass=[1.0, 0.0], radius=[0.2, 0.0])
    s2, full = _create(jp, js, density=cd[order[5]])
    assert full == 0 and int(s2.n_alive) == 3
    new = int(torch.nonzero(s2.alive & ~torch.tensor(
        np.asarray(js.alive)))[0, 0])
    assert float(s2.radius[new]) == pytest.approx(
        2.0 * float(np.asarray(jp.h)[order[1]]))
    np.testing.assert_allclose(s2.pos[new].numpy(),
                               np.asarray(jp.pos)[order[1]])


def test_create_sinks_ignores_the_dummy_sink():
    jp = _gas()
    cd = _code_density(jp)
    best = int(np.argmax(cd[:96]))
    # the zero-mass dummy sink planted at the densest particle vetoes
    # nothing
    js = _sinks([np.asarray(jp.pos)[best]], mass=[0.0], radius=[5.0])
    s2, full = _create(jp, js, density=0.5 * cd[best])
    assert full == 0 and int(s2.n_alive) == 2
    assert float(s2.mass[1]) == 1e-6


def test_create_sinks_reports_full_slots():
    jp = _gas()
    cd = _code_density(jp)
    js = _sinks([[40.0, 0, 0], [0, 40.0, 0], [0, 0, 40.0], [40.0, 40, 0]],
                mass=[1.0] * 4, radius=[0.5] * 4)
    s2, full = _create(jp, js, density=0.5 * float(cd[:96].max()))
    assert full == 1 and int(s2.n_alive) == 4
    # nothing eligible: no sink, nothing full
    _, full = _create(jp, js, density=2.0 * float(cd[:96].max()))
    assert full == 0


def test_merge_sinks_chain_needs_pointer_jumping():
    """Sinks 0-1 and 1-2 are inside each other's merge distance, 0-2 are
    not: sink 2 points at 1, which points at 0, so only pointer jumping
    brings all three onto root 0.  Sink 3 stays alone; slot 4 is free."""
    from summersph_tpu.ops.sinks import merge_sinks as jax_merge

    rng = np.random.default_rng(7)
    pos = [[0.0, 0, 0], [0.8, 0.1, 0], [1.6, 0.0, 0.2], [9.0, 0, 0]]
    js = _sinks(pos, mass=[1.0, 0.5, 0.25, 2.0], radius=[1.0, 1.2, 1.0, 1.0],
                capacity=5, vel=rng.normal(0, 0.3, (4, 3)))
    js = js.replace(spin=jnp.asarray(rng.normal(0, 0.1, (5, 3))))
    jcfg = JaxConfig(sink_merge_factor=1.0)
    js2, jn = jax_merge(js, jcfg)
    _, st = _both(_gas(), js)
    s2, n = sinks.merge_sinks(st.sinks, SimConfig(sink_merge_factor=1.0))
    _hold_sinks(s2, js2)
    assert int(n) == int(jn) == 2
    assert s2.alive.tolist() == [True, False, False, True, False]
    assert float(s2.mass[0]) == pytest.approx(1.75)
    # momentum and angular momentum about the origin are conserved
    m0, v0, x0 = (np.asarray(js.mass), np.asarray(js.vel),
                  np.asarray(js.pos))
    m1, v1, x1 = s2.mass.numpy(), s2.vel.numpy(), s2.pos.numpy()
    live = s2.alive.numpy()
    np.testing.assert_allclose((m1[live, None] * v1[live]).sum(0),
                               (m0[:, None] * v0).sum(0), rtol=1e-12)
    spin0 = np.asarray(js.spin)[np.asarray(js.alive)]
    l0 = (m0[:, None] * np.cross(x0, v0)).sum(0) + spin0.sum(0)
    l1 = ((m1[live, None] * np.cross(x1[live], v1[live])).sum(0)
          + s2.spin.numpy()[live].sum(0))
    np.testing.assert_allclose(l1, l0, rtol=1e-12)
