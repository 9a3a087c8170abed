"""The pair passes of `ops/cuda_pairs.py`, the module that holds the CUDA
kernels.

On the CPU the wrappers take their plain PyTorch versions, held here
against the JAX package: against the Pallas kernels run in interpret mode
(f32, with tests/test_pallas.py's tolerances) and against the XLA sorted
engine in f64.  The JAX side only compares where it drops nothing
(`window_overflow == 0`, `n_window_overflow == 0`).  Per-pid comparisons:
the JAX sort is unstable.

The tests marked `gpu` hold each CUDA kernel, fixed-h and variable-h,
against its plain version on the card; they skip without one.  It needs no JAX, so this file runs on a
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


def _launch_counts():
    return (cuda_pairs.density_sums.launches,
            cuda_pairs.density_sums.var_launches,
            cuda_pairs.force_sums.launches,
            cuda_pairs.force_sums.fused_launches,
            cuda_pairs.force_sums.var_launches,
            cuda_pairs.force_sums.var_fused_launches,
            cuda_pairs.grav_short_sums.launches)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper is its plain version, bit for bit, with no
    launch: fixed h, and a variable-h config (fixed_h=None) through the
    grad-h plain versions."""
    p2, grid, cfg = _small_disc("cpu")
    before = _launch_counts()
    split = (torch.tensor(0.9), torch.tensor(4.5 * 0.9))
    for c in (cfg, cfg.with_(fixed_h=None)):
        sums = cuda_pairs.density_sums(p2, c, grid)
        for a, b in zip(sums, cuda_pairs.density_sums_plain(p2, c, grid)):
            assert torch.equal(a, b)
        assert bool((sums[1] != 0).any()) == (c.fixed_h is None)
        p3, _, _, _ = cuda_pairs.pair_eval(p2, c, grid)
        for sp in (None, split):
            ours = cuda_pairs.force_sums(p3, c, grid, sp)
            plain = cuda_pairs.force_sums_plain(p3, c, grid, sp)
            for a, b in zip(ours[:5], plain[:5]):
                assert torch.equal(a, b)
    assert _launch_counts() == before
    over = cuda_pairs.window_overflow(grid, cfg)
    assert over.dtype == torch.int32 and int(over) == 0


def test_plain_versions_chunk_without_changing_the_sums(monkeypatch):
    p2, grid, cfg = _small_disc("cpu", n=2048)
    p3, _, _, _ = cuda_pairs.pair_eval(p2, cfg, grid)
    whole = (*cuda_pairs.density_sums_plain(p2, cfg, grid),
             *cuda_pairs.force_sums_plain(p3, cfg, grid))
    monkeypatch.setattr(cuda_pairs, "PAIR_BUDGET", 1)  # one group a chunk
    chunked = (*cuda_pairs.density_sums_plain(p2, cfg, grid),
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
    rho_raw, omega_raw = cuda_pairs.density_sums(p2, cfg, grid)
    assert cuda_pairs.density_sums.launches == n0 + 1
    torch.testing.assert_close(
        rho_raw, cuda_pairs.density_sums_plain(p2, cfg, grid)[0], **RHO_TOL)
    assert not bool(omega_raw.any())

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

    # the fused form: the same five sums as force_fixed_h, plus gravity
    split = (torch.tensor(0.9, device=cuda_device),
             torch.tensor(4.5 * 0.9, device=cuda_device))
    n0 = cuda_pairs.force_sums.fused_launches
    fused = cuda_pairs.force_sums(p3, cfg, grid, split)
    assert cuda_pairs.force_sums.fused_launches == n0 + 1
    plain = cuda_pairs.force_sums_plain(p3, cfg, grid, split)
    for a, b in zip(fused[:5], ours):
        assert torch.equal(a, b)
    exact = cuda_pairs.force_sums_plain(
        p3.map(lambda a: a.double() if a.is_floating_point() else a), cfg,
        grid, tuple(v.double() for v in split))[5]
    _hold_f64(("gx", "gy", "gz"), fused[5], plain[5], exact)

    # the short-range gravity kernel on the gravity sort
    from summersph_tpu_torch.ops import pm_gravity
    gcfg = cfg.with_(gravity="pm", window_group=32, grav_grid=128)
    st, _ = disc_ic(n=32768, h0=5.0, cfg=gcfg, seed=2, device=cuda_device)
    r_s = pm_gravity.pm_geometry(st.particles, gcfg)[2]
    pos, m, h, ggrid, _, split = pm_gravity.gravity_sort(st.particles, gcfg,
                                                         r_s)
    n0 = cuda_pairs.grav_short_sums.launches
    ours = cuda_pairs.grav_short_sums(pos, m, h, ggrid, gcfg, split)
    assert cuda_pairs.grav_short_sums.launches == n0 + 1
    plain = cuda_pairs.grav_short_sums_plain(pos, m, h, ggrid, gcfg, split)
    exact = cuda_pairs.grav_short_sums_plain(
        pos.double(), m.double(), h.double(), ggrid, gcfg,
        tuple(v.double() for v in split))
    _hold_f64(("gx", "gy", "gz"), ours, plain, exact)


def _collapse_sorted(device, n=32768):
    """A 32,768-particle config-5 collapse sphere (h0 scaled as config 5
    scales it) after one standalone h-iteration, which spreads h (the rim
    grows it), sorted with the variable-h sort headroom."""
    from summersph_tpu_torch.models.disc import collapse_ic
    from summersph_tpu_torch.ops.smoothing import update_smoothing

    h0 = (1_048_576 / n) ** (1.0 / 3.0)
    cfg = SimConfig(fixed_h=None, neighbor_mode="sorted", window_group=32,
                    cell_h_quantile=0.9, gravity="pm", grav_grid=128,
                    gamma=1.1, max_length=1.5 * h0)
    st, _ = collapse_ic(n=n, r_max=50.0, m_total=50.0, h0=h0, cfg=cfg,
                        rotation="rigidbody", v_circ=4.2, seed=0,
                        device=device)
    p, _ = update_smoothing(st.particles, cfg)
    p2, grid = sort_particles(p, cfg, h_pad=cfg.sort_h_pad)
    return p2, grid, cfg


def _f64(p):
    return p.map(lambda a: a.double() if a.is_floating_point() else a)


@pytest.mark.gpu
def test_cuda_var_h_kernels_match_plain_versions(cuda_device):
    """density_var_h, force_var_h and force_var_h_grav against their plain
    versions on the card; each launch counted in its own attribute.  On
    the rigidly rotating cloud div v ~ 0, so du and alpha_raw, like
    Omega_raw (dW/dh of both signs) and the gravity sums, are sums that
    cancel: they are held against the plain version in float64."""
    p2, grid, cfg = _collapse_sorted(cuda_device)
    n0 = _launch_counts()
    ours = cuda_pairs.density_sums(p2, cfg, grid)
    assert _launch_counts()[1] == n0[1] + 1
    plain = cuda_pairs.density_sums_plain(p2, cfg, grid)
    torch.testing.assert_close(ours[0], plain[0], **RHO_TOL)
    exact = cuda_pairs.density_sums_plain(_f64(p2), cfg, grid)
    _hold_f64(("omega_raw",), ours[1:], plain[1:], exact[1:])

    p3, _, _, _ = cuda_pairs.pair_eval(p2, cfg, grid)
    n0 = _launch_counts()
    ours = cuda_pairs.force_sums(p3, cfg, grid)
    assert _launch_counts()[4] == n0[4] + 1
    plain = cuda_pairs.force_sums_plain(p3, cfg, grid)
    exact = cuda_pairs.force_sums_plain(_f64(p3), cfg, grid)
    _hold_f64(("ax", "ay", "az", "du", "araw"), ours, plain, exact)

    from summersph_tpu_torch.ops import pm_gravity
    r_s = pm_gravity.pm_geometry(p2, cfg)[2]
    split = (r_s, cfg.effective_rcut_rs() * r_s)
    n0 = _launch_counts()
    fused = cuda_pairs.force_sums(p3, cfg, grid, split)
    assert _launch_counts()[5] == n0[5] + 1
    for a, b in zip(fused[:5], ours):
        assert torch.equal(a, b)
    plain = cuda_pairs.force_sums_plain(p3, cfg, grid, split)
    exact = cuda_pairs.force_sums_plain(
        _f64(p3), cfg, grid, tuple(v.double() for v in split))[5]
    _hold_f64(("gx", "gy", "gz"), fused[5], plain[5], exact)
    assert _launch_counts()[0] == n0[0] and _launch_counts()[2] == n0[2]


def _hold_f64(names, ours, plain, exact):
    """Sums whose terms nearly cancel (the gravity sums' f(r/h) - S(r);
    du, alpha_raw and Omega_raw of a rotating cloud) lose digits in
    float32 in the kernel and its plain version alike: hold the kernel
    against the plain version in float64 within rtol 2e-4 and atol
    1e-5 x max|component| + twice the float32 plain version's own largest
    error."""
    for name, a, b, r in zip(names, ours, plain, exact):
        floor = float((b.double() - r).abs().max())
        torch.testing.assert_close(
            a.double(), r, rtol=FORCE_TOL["rtol"],
            atol=1e-5 * float(r.abs().max()) + 2 * floor, msg=name)
