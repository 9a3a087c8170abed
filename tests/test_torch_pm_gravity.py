"""The port's gravity operators (`ops/gravity.py::gas_gravity_direct`,
`ops/pm_gravity.py`) against the JAX package's, on identical inputs made
with numpy from a seed.

The short-range pass runs its plain version here (the `grav_short` CUDA
kernel needs the card); the JAX side runs its XLA sorted path with
windows that cover every candidate.  Per-particle comparisons are in the
caller's order, which both packages keep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.ops import gravity as jgravity
from summersph_tpu.ops import pm_gravity as jpm
from summersph_tpu.state import Particles as JParticles
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops import cuda_pairs, gravity, pm_gravity
from summersph_tpu_torch.ops.sorted_grid import sort_particles

from test_torch_config_state import port_particles


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(n=512, r=50.0, h=1.0, seed=0, capacity=None,
           dtype=jnp.float64):
    """tests/test_gravity.py's Gaussian cloud."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)) * r / 3
    return JParticles.create(pos=pos, vel=np.zeros((n, 3)),
                             mass=rng.random(n) / n + 0.5 / n,
                             u=np.ones(n), h=h, capacity=capacity,
                             dtype=dtype)


def _with_dead(jp, every=7):
    from summersph_tpu.state import PARK_POSITION
    alive = jnp.asarray(np.arange(jp.capacity) % every != 3) & jp.alive
    return jp.replace(alive=alive, mass=jnp.where(alive, jp.mass, 0.0),
                      pos=jnp.where(alive[:, None], jp.pos, PARK_POSITION))


def _two_blobs(npart=512, dtype=jnp.float64):
    """tests/test_mm_dft.py's clustered set."""
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.normal(0.0, 1.0, (npart // 2, 3)),
                          rng.normal(3.0, 0.3, (npart // 2, 3))])
    return JParticles.zeros(npart, dtype).replace(
        pos=jnp.asarray(pos, dtype),
        mass=jnp.full((npart,), 1.0 / npart, dtype),
        alive=jnp.ones((npart,), bool))


def _clustered(n=2048, seed=3):
    """tests/test_grav_overflow.py's clump: 3/4 of the mass within ~1 AU,
    so one r_cut cell holds hundreds of particles."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    pos[: 3 * n // 4] = rng.normal(0, 1.2, (3 * n // 4, 3))
    return JParticles.zeros(n, jnp.float32).replace(
        pos=jnp.asarray(pos), mass=jnp.full((n,), 1e-3, jnp.float32),
        h=jnp.full((n,), 0.5, jnp.float32),
        alive=jnp.ones((n,), bool), pid=jnp.arange(n, dtype=jnp.int32))


# ---------------------------------------------------------------- mesh

@pytest.mark.parametrize("npad,rs", [(32, 1.0), (64, 1.5)])
def test_green_table_matches_jax(npad, rs):
    ours = pm_gravity.green_kernel_k(npad, rs, torch.float64,
                                     torch.device("cpu"))
    theirs = np.asarray(jpm.green_kernel_k(npad, rs, "float64"))
    assert ours.shape == theirs.shape == (npad, npad, npad // 2 + 1)
    # the two FFTs round differently: the small high-k entries also get
    # an atol at 1e-13 of the largest entry
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-10,
                               atol=1e-13 * np.abs(theirs).max())


@pytest.mark.parametrize("name", ["pm_geometry", "_cic_deposit",
                                  "_cic_gather", "_fd4_gradient"])
def test_mesh_operators_match_jax(name):
    n = 16
    jp = _with_dead(_cloud(n=300, capacity=320))
    jcfg, cfg = (JaxConfig(gravity="pm", grav_grid=n),
                 SimConfig(gravity="pm", grav_grid=n))
    jorigin, jcell, jrs = jpm.pm_geometry(jp, jcfg)
    p = port_particles(jp)
    if name == "pm_geometry":
        for ours, theirs in zip(pm_gravity.pm_geometry(p, cfg),
                                (jorigin, jcell, jrs)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-12)
        return
    origin, cell = _t(jorigin), _t(jcell)
    rng = np.random.default_rng(5)
    if name == "_cic_deposit":
        m = np.where(np.asarray(jp.alive), np.asarray(jp.mass), 0.0)
        ours = pm_gravity._cic_deposit(p.pos, _t(m), origin, cell, n)
        theirs = jpm._cic_deposit(jp.pos, jnp.asarray(m), jorigin, jcell, n)
    elif name == "_cic_gather":
        # live rows only: both callers mask the dead rows, whose parked
        # positions overflow the JAX int32 cell index
        field = rng.standard_normal((n, n, n, 3))
        live = np.asarray(jp.alive)
        ours = pm_gravity._cic_gather(_t(field), p.pos, origin, cell,
                                      n)[live]
        theirs = jpm._cic_gather(jnp.asarray(field), jp.pos, jorigin, jcell,
                                 n)[live]
    else:
        phi = rng.standard_normal((2 * n, 2 * n, 2 * n))
        ours = torch.stack(pm_gravity._fd4_gradient(_t(phi), 0.7))
        theirs = jnp.stack(jpm._fd4_gradient(jnp.asarray(phi), 0.7))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12)


@pytest.mark.parametrize("gradient", ["fd", "spectral"])
def test_pm_long_range_matches_jax_xla(gradient):
    jp = _two_blobs()
    kw = dict(gravity="pm", grav_grid=32, grav_fft="xla",
              grav_gradient=gradient, dtype="float64")
    jcfg = JaxConfig(**kw)
    jacc, _, _, jrs = jpm.pm_long_range(
        jp, jcfg, kern_k=jpm.grav_tables(jcfg, jnp.float64))
    acc, _, _, r_s = pm_gravity.pm_long_range(port_particles(jp),
                                              SimConfig(**kw))
    theirs = np.asarray(jacc)
    np.testing.assert_allclose(acc.numpy(), theirs,
                               atol=1e-9 * np.abs(theirs).max())
    np.testing.assert_allclose(float(r_s), float(jrs), rtol=1e-12)


def test_matmul_alias_matches_jax_matmul():
    """grav_fft='matmul' names the one torch.fft path; it matches the JAX
    pruned matmul DFT at tests/test_mm_dft.py's transform atol, scaled by
    the largest component."""
    jp = _two_blobs()
    kw = dict(gravity="pm", grav_grid=32, grav_fft="matmul",
              dtype="float64")
    jcfg = JaxConfig(**kw)
    jacc = jpm.pm_long_range(jp, jcfg,
                             kern_k=jpm.grav_tables(jcfg, jnp.float64))[0]
    acc = pm_gravity.pm_long_range(port_particles(jp), SimConfig(**kw))[0]
    theirs = np.asarray(jacc)
    np.testing.assert_allclose(acc.numpy(), theirs,
                               atol=1e-9 * np.abs(theirs).max())
    with pytest.raises(ValueError):
        pm_gravity.pm_long_range(port_particles(jp),
                                 SimConfig(**kw, grav_gradient="spectral"))


# ---------------------------------------------------------- short range

def test_pm_short_range_matches_jax_xla_f64():
    """tests/test_gravity.py's uniform cloud at r_s = 4 (r_cut = 18),
    against the XLA slab path with windows deep enough to cover it."""
    rng = np.random.default_rng(0)
    n = 768
    jp = JParticles.create(pos=rng.uniform(-50, 50, (n, 3)),
                           vel=np.zeros((n, 3)), mass=np.full(n, 1.0 / n),
                           u=np.ones(n), h=2.0, dtype=jnp.float64)
    kw = dict(gravity="pm", neighbor_mode="sorted", sorted_block=128,
              window_group=32, grav_window_blocks=12, use_pallas=False)
    jacc, j_over = jpm.pm_short_range(jp, JaxConfig(**kw),
                                      jnp.asarray(4.0))
    assert int(j_over) == 0
    acc, over = pm_gravity.pm_short_range(
        port_particles(jp), SimConfig(**kw),
        torch.tensor(4.0, dtype=torch.float64))
    assert over.dtype == torch.int32 and int(over) == 0
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-9)


@pytest.mark.parametrize("items", [0, 64, 2048])
def test_clustered_clump_matches_deep_windows(items):
    """The clump that overflows a static window plan: the port's kernel
    walks every range, so it matches the JAX deep-window result at the
    JAX test's 1e-5 with no overflow whatever grav_overflow_items says."""
    jp = _clustered()
    base = dict(gravity="pm", grav_grid=32, neighbor_mode="sorted",
                use_pallas=False, sorted_block=128, window_group=32,
                fixed_h=2.0)
    a_d, o_d = jpm.gas_gravity_pm(jp, JaxConfig(**base,
                                                grav_window_blocks=16))
    assert int(o_d) == 0
    acc, over = pm_gravity.gas_gravity_pm(
        port_particles(jp), SimConfig(**base, grav_window_blocks=2,
                                      grav_overflow_items=items))
    assert int(over) == 0
    a_d = np.asarray(a_d)
    scale = np.linalg.norm(a_d, axis=1).max()
    err = np.linalg.norm(acc.numpy() - a_d, axis=1).max() / scale
    assert err < 1e-5, err


def test_pm_matches_direct_on_cloud():
    """PM + short range against the exact oracle, both the port's, within
    the JAX test's bounds (rms < 1%, median < 0.5%)."""
    p = port_particles(_cloud(n=768, h=0.5, capacity=768))
    cfg = SimConfig(gravity="pm", grav_grid=64, neighbor_mode="sorted",
                    sorted_block=64)
    a_direct = gravity.gas_gravity_direct(p, cfg).numpy()
    a_pm, n_over = pm_gravity.gas_gravity_pm(p, cfg)
    assert int(n_over) == 0
    rel = (np.linalg.norm(a_pm.numpy() - a_direct, axis=1)
           / np.maximum(np.linalg.norm(a_direct, axis=1), 1e-12))
    assert np.sqrt(np.mean(rel ** 2)) < 0.01
    assert np.median(rel) < 0.005


def test_gas_gravity_direct_matches_jax():
    jp = _with_dead(_cloud(n=300, h=1.5, capacity=320))
    cfg = SimConfig(gravity="direct")
    ours = gravity.gas_gravity_direct(port_particles(jp), cfg)
    theirs = jgravity.gas_gravity_direct(jp, JaxConfig(gravity="direct"))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12)


def test_dead_particles_get_zero_acceleration():
    p = port_particles(_cloud(n=256, h=0.5, capacity=300))
    cfg = SimConfig(gravity="pm", grav_grid=32)
    for acc in (pm_gravity.gas_gravity_pm(p, cfg)[0],
                pm_gravity.pm_long_range(p, cfg)[0],
                gravity.gas_gravity_direct(p, cfg)):
        assert torch.isfinite(acc).all()
        assert torch.all(acc[256:] == 0.0)
        assert torch.all(acc[:256].abs().sum(dim=1) > 0.0)


def test_cpu_tensors_take_the_plain_gravity_versions():
    """On the CPU the gravity wrappers run their plain versions and
    count no launch; the fused force form equals the plain one."""
    jp = _cloud(n=500, h=2.0, capacity=512, dtype=jnp.float32)
    p = port_particles(jp)
    cfg = SimConfig(fixed_h=2.0, gravity="pm", neighbor_mode="sorted",
                    window_group=32)
    split = (torch.tensor(1.5), torch.tensor(4.5 * 1.5))
    before = (cuda_pairs.grav_short_sums.launches,
              cuda_pairs.force_sums.fused_launches)
    p2, grid = sort_particles(p, cfg)
    m = torch.where(p2.alive, p2.mass, 0.0)
    for a, b in zip(
            cuda_pairs.grav_short_sums(p2.pos, m, p2.h, grid, cfg, split),
            cuda_pairs.grav_short_sums_plain(p2.pos, m, p2.h, grid, cfg,
                                             split)):
        assert torch.equal(a, b)
    p3 = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    fused = cuda_pairs.force_sums(p3, cfg, grid, split)
    plain = cuda_pairs.force_sums_plain(p3, cfg, grid, split)
    for a, b in zip(fused[:5] + fused[5], plain[:5] + plain[5]):
        assert torch.equal(a, b)
    for a, b in zip(fused[:5], cuda_pairs.force_sums(p3, cfg, grid)):
        assert torch.equal(a, b)
    assert (cuda_pairs.grav_short_sums.launches,
            cuda_pairs.force_sums.fused_launches) == before
