"""The pair passes of `ops/cuda_pairs.py`, the module that holds the CUDA
kernels.

On the CPU the wrappers take their plain PyTorch versions, held here
against the JAX package: against the Pallas kernels run in interpret mode
(f32, with tests/test_pallas.py's tolerances) and against the XLA sorted
engine in f64.  The JAX side only compares where it drops nothing
(`window_overflow == 0`, `n_window_overflow == 0`).  Per-pid comparisons:
the JAX sort is unstable.

The test marked `gpu` holds each CUDA kernel against its plain version on
the card; it skips without one.  It needs no JAX, so this file runs on a
GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_pairs.py
"""

import numpy as np
import pytest
import torch

from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.ops import cuda_pairs
from summersph_tpu_torch.ops.sorted_grid import sort_particles

# tests/test_pallas.py's f32 tolerances
RHO_TOL = dict(rtol=2e-5, atol=1e-7)
FORCE_TOL = dict(rtol=2e-4, atol=1e-6)


def _kw(**extra):
    return dict(fixed_h=1.3, neighbor_mode="sorted", sorted_block=128,
                window_blocks=5, pallas_window=640, use_pallas=True, **extra)


def _jax_lattice(dead: bool):
    """The JAX tests' jittered 8^3 lattice (h = 1.3), optionally with every
    fourth particle dead."""
    import jax.numpy as jnp
    from summersph_tpu.state import PARK_POSITION
    from test_density_forces import lattice_particles

    p = lattice_particles(nside=8, spacing=1.0, h=1.3, jitter=0.25)
    if dead:
        alive = jnp.arange(p.capacity) % 4 != 0
        p = p.replace(alive=alive, mass=jnp.where(alive, p.mass, 0.0),
                      pos=jnp.where(alive[:, None], p.pos, PARK_POSITION))
    return p


def _port_pair_eval(jp, cfg):
    """The port's whole pair pass from the unsorted JAX particles."""
    from test_torch_config_state import port_particles

    p2, grid = sort_particles(port_particles(jp), cfg)
    p3, acc, du, dalpha = cuda_pairs.pair_eval(p2, cfg, grid)
    order = np.argsort(p3.pid.numpy())
    return {"rho": p3.rho.numpy()[order], "acc": acc.numpy()[order],
            "du": du.numpy()[order], "dalpha": dalpha.numpy()[order],
            "alive": p3.alive.numpy()[order]}


def _by_pid(p, **arrays):
    order = np.argsort(np.asarray(p.pid))
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


def test_plain_pair_eval_matches_pallas_interpret_f32():
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops.pallas_pairs import (pallas_pair_eval,
                                                window_overflow)
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort

    jp = _jax_lattice(dead=False)
    jcfg = JaxConfig(**_kw())
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(window_overflow(jgrid, jcfg)) == 0
    jp3, jacc, jdu, jdal = pallas_pair_eval(jp2, jcfg, jgrid, interpret=True)
    theirs = _by_pid(jp3, rho=jp3.rho, acc=jacc, du=jdu, dalpha=jdal)

    ours = _port_pair_eval(jp, SimConfig(**_kw()))
    assert ours["rho"].dtype == np.float32
    np.testing.assert_allclose(ours["rho"], theirs["rho"], **RHO_TOL)
    for name in ("acc", "du", "dalpha"):
        np.testing.assert_allclose(ours[name], theirs[name], **FORCE_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dead", [False, True])
def test_plain_pair_eval_matches_xla_sorted_engine_f64(dead):
    import jax.numpy as jnp
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops.eos import eos_update
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
    from summersph_tpu.ops.sorted_grid import sorted_density, sorted_forces

    jp = _jax_lattice(dead)
    jp = jp.replace(**{f: getattr(jp, f).astype(jnp.float64) for f in
                       ("pos", "vel", "acc", "mass", "u", "rho", "pressure",
                        "cs", "du", "alpha", "dalpha", "h", "omega")})
    jcfg = JaxConfig(**_kw(dtype="float64"))
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(jgrid.n_window_overflow) == 0
    jp3 = eos_update(sorted_density(jp2, jcfg, jgrid), jcfg)
    jacc, jdu, jdal = sorted_forces(jp3, jcfg, jgrid)
    theirs = _by_pid(jp3, rho=jp3.rho, acc=jacc, du=jdu, dalpha=jdal,
                     alive=jp3.alive)

    ours = _port_pair_eval(jp, SimConfig(**_kw(dtype="float64")))
    assert ours["rho"].dtype == np.float64
    np.testing.assert_array_equal(ours["alive"], theirs["alive"])
    for name in ("rho", "acc", "du", "dalpha"):
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-9,
                                   err_msg=name)


def _small_disc(device, n=4096, seed=1):
    h0 = 100.0 * (60.0 / n) ** (1.0 / 3.0) / 2.0
    cfg = SimConfig(fixed_h=h0, neighbor_mode="sorted", window_group=64)
    st, _ = disc_ic(n=n, h0=h0, cfg=cfg, seed=seed, device=device)
    p2, grid = sort_particles(st.particles, cfg)
    return p2, grid, cfg


def test_cpu_tensors_take_the_plain_versions():
    p2, grid, cfg = _small_disc("cpu")
    before = (cuda_pairs.density_sums.launches,
              cuda_pairs.force_sums.launches)
    rho_raw = cuda_pairs.density_sums(p2, cfg, grid)
    assert torch.equal(rho_raw, cuda_pairs.density_sums_plain(p2, cfg, grid))
    p3, _, _, _ = cuda_pairs.pair_eval(p2, cfg, grid)
    for a, b in zip(cuda_pairs.force_sums(p3, cfg, grid),
                    cuda_pairs.force_sums_plain(p3, cfg, grid)):
        assert torch.equal(a, b)
    assert (cuda_pairs.density_sums.launches,
            cuda_pairs.force_sums.launches) == before
    over = cuda_pairs.window_overflow(grid, cfg)
    assert over.dtype == torch.int32 and int(over) == 0
    with pytest.raises(NotImplementedError):
        cuda_pairs.density_sums(p2, cfg.with_(fixed_h=None), grid)


def test_plain_versions_chunk_without_changing_the_sums(monkeypatch):
    p2, grid, cfg = _small_disc("cpu", n=2048)
    p3, _, _, _ = cuda_pairs.pair_eval(p2, cfg, grid)
    whole = (cuda_pairs.density_sums_plain(p2, cfg, grid),
             *cuda_pairs.force_sums_plain(p3, cfg, grid))
    monkeypatch.setattr(cuda_pairs, "PAIR_BUDGET", 1)  # one group a chunk
    chunked = (cuda_pairs.density_sums_plain(p2, cfg, grid),
               *cuda_pairs.force_sums_plain(p3, cfg, grid))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(cuda_device):
    p2, grid, cfg = _small_disc(cuda_device, n=32768)
    n0 = cuda_pairs.density_sums.launches
    rho_raw = cuda_pairs.density_sums(p2, cfg, grid)
    assert cuda_pairs.density_sums.launches == n0 + 1
    torch.testing.assert_close(
        rho_raw, cuda_pairs.density_sums_plain(p2, cfg, grid), **RHO_TOL)

    p3, _, _, _ = cuda_pairs.pair_eval(p2, cfg, grid)
    n0 = cuda_pairs.force_sums.launches
    ours = cuda_pairs.force_sums(p3, cfg, grid)
    assert cuda_pairs.force_sums.launches == n0 + 1
    plain = cuda_pairs.force_sums_plain(p3, cfg, grid)
    for name, a, b in zip(("ax", "ay", "az", "du", "araw"), ours, plain):
        # sums in another order: atol scaled to the component's magnitude
        torch.testing.assert_close(
            a, b, rtol=FORCE_TOL["rtol"],
            atol=1e-5 * float(b.abs().max()), msg=name)

    with pytest.raises(TypeError):
        cuda_pairs.density_sums(p2.map(
            lambda a: a.double() if a.is_floating_point() else a), cfg, grid)
