"""Block timesteps in the port (`summersph_tpu_torch/blockstep.py`) and the
gated forms of the pair passes, module by module against the JAX package.

On the CPU the gated wrappers take their plain versions.  The rung and
mask arithmetic and the worklist must equal JAX exactly; the substep sort
(carry_derived, extra) per pid; the gated pair passes the JAX gated Pallas
kernels in interpret mode at tests/test_pallas.py's float32 tolerances.
The JAX kernels gate at `sorted_block` rows and the port at
`window_group`, so the two are compared on the active rows and, where the
wrappers zero them, on the rest.  Comparisons are per pid: the JAX sort is
unstable.  The whole engine is held in test_torch_blockstep_engine.py.

The test marked `gpu` holds the seven gated CUDA kernels to the ungated
ones on the card; it needs no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_blockstep.py
"""

import numpy as np
import pytest
import torch

from summersph_tpu_torch import blockstep
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import check_supported
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.ops import cuda_pairs, pm_gravity, smoothing
from summersph_tpu_torch.ops.sorted_grid import (group_worklist,
                                                 sort_particles)
from summersph_tpu_torch.state import Particles

# tests/test_pallas.py's f32 tolerances
RHO_TOL = dict(rtol=2e-5, atol=1e-7)
FORCE_TOL = dict(rtol=2e-4, atol=1e-6)


def _per_pid(pid, **arrays):
    order = np.argsort(np.asarray(pid))
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


# ------------------------------------------------- rungs, masks, worklist

def test_rung_and_mask_arithmetic_equals_jax():
    import jax.numpy as jnp
    from summersph_tpu import blockstep as jbs
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.state import Particles as JParticles

    rng = np.random.default_rng(0)
    n, bins = 256, 4
    # candidates from 1e-12 to beyond dt_base, exact powers of two among
    # them, routed through t_acc = |v| / |a| with |v| = 1
    cand = np.concatenate([2.0 ** -np.arange(16.0), [1e-12, 3.0, 0.51],
                           10.0 ** rng.uniform(-4, 1, n - 19)])
    vel = np.zeros((n, 3))
    vel[:, 0] = 1.0
    acc = np.zeros((n, 3))
    acc[:, 0] = 1.0 / cand
    alive = np.arange(n) % 11 != 5
    for dtype, jdt in (("float32", jnp.float32), ("float64", jnp.float64)):
        kw = dict(dt_bins=bins, timestep_scale=1.0, fixed_h=None,
                  dtype=dtype)
        jp = JParticles.zeros(n, jdt).replace(
            alive=jnp.asarray(alive), vel=jnp.asarray(vel, jdt),
            acc=jnp.asarray(acc, jdt), u=jnp.full((n,), 1e9, jdt),
            h=jnp.full((n,), 1e9, jdt))
        tdt = getattr(torch, dtype)
        p = Particles.zeros(n, tdt, "cpu").replace(
            alive=torch.from_numpy(alive), vel=torch.tensor(vel, dtype=tdt),
            acc=torch.tensor(acc, dtype=tdt),
            u=torch.full((n,), 1e9, dtype=tdt),
            h=torch.full((n,), 1e9, dtype=tdt))
        jr = jbs.assign_rungs(jp, JaxConfig(**kw), 1.0)
        r = blockstep.assign_rungs(p, SimConfig(**kw), torch.tensor(
            1.0, dtype=tdt))
        assert r.dtype == torch.int32
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        assert set(r.tolist()) == set(range(bins))
        m = 1 << (bins - 1)
        for j in range(m):
            np.testing.assert_array_equal(
                blockstep.closing_mask(r, j, m).numpy(),
                np.asarray(jbs.closing_mask(jr, j, m)))
            np.testing.assert_array_equal(
                blockstep.opening_mask(r, j, m).numpy(),
                np.asarray(jbs.opening_mask(jr, j, m)))
        # exact powers of two in torch; XLA's exp2 on the CPU may be an ulp
        # off, so rung_dt is held to 2 ulp and to the exact value
        dt_r = blockstep.rung_dt(r, torch.tensor(0.37, dtype=tdt), tdt)
        np.testing.assert_allclose(
            dt_r.numpy(),
            np.asarray(jbs.rung_dt(jr, jnp.asarray(0.37, jdt), jdt)),
            rtol=2 * np.finfo(dtype).eps, atol=0)
        np.testing.assert_array_equal(
            dt_r.numpy(), np.asarray(0.37, dtype) / 2.0 ** r.numpy())


@pytest.mark.parametrize("block", [128, 32])
def test_group_worklist_equals_jax(block):
    import jax.numpy as jnp
    from summersph_tpu.blockstep import group_worklist as jax_worklist

    rng = np.random.default_rng(block)
    cases = [np.zeros(1024, bool), np.ones(1024, bool),
             rng.random(1024) < 0.004, rng.random(1024) < 0.5]
    cases[0][[130, 400, 1023]] = True
    cases.append(np.zeros(1024, bool))          # nothing active
    for act in cases:
        work, count = group_worklist(torch.from_numpy(act), block)
        jwork, jcount = jax_worklist(jnp.asarray(act), block)
        assert work.dtype == count.dtype == torch.int32
        assert count.shape == (1,) and work.shape == (1024 // block,)
        np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
        np.testing.assert_array_equal(work.numpy(), np.asarray(jwork))
    assert blockstep.group_worklist is group_worklist


# ------------------------------------------------------- the substep sort

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sort_carries_derived_fields_and_extra_like_jax(dtype):
    import jax.numpy as jnp
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.models.disc import disc_ic as jax_disc_ic
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
    from test_torch_config_state import port_particles

    kw = dict(fixed_h=None, neighbor_mode="sorted", sorted_block=128,
              window_group=32, kahan_u=True, dtype=dtype)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    # 300 live particles in 320 slots: the sort pads to 384
    jst, _ = jax_disc_ic(n=300, capacity=320, r_max=10.0, m_star=1.0,
                         h0=1.5, cfg=jcfg, seed=4)
    rng = np.random.default_rng(7)
    jp = jst.particles
    fdt = jp.pos.dtype
    derived = {name: jnp.asarray(rng.random(getattr(jp, name).shape), fdt)
               for name in ("rho", "pressure", "cs", "omega", "acc", "du",
                            "dalpha")}
    jp = jp.replace(u_c=jnp.asarray(rng.random(320) * 1e-6, fdt),
                    acc_ext=jnp.asarray(rng.random((320, 3)), fdt),
                    **derived)
    rung = rng.integers(0, 4, 320).astype(np.int32)

    jp2, jgrid, jrung = jax_sort(jp, jcfg, h_pad=1.2, carry_derived=True,
                                 extra=jnp.asarray(rung))
    p2, grid, rung_s = sort_particles(port_particles(jp), cfg, h_pad=1.2,
                                      carry_derived=True,
                                      extra=torch.from_numpy(rung))
    assert p2.capacity == jp2.capacity == 384 and rung_s.shape == (384,)
    np.testing.assert_array_equal(grid.key.numpy(), np.asarray(jgrid.key))
    np.testing.assert_array_equal(grid.starts.numpy(),
                                  np.asarray(jgrid.starts))
    np.testing.assert_array_equal(grid.ends.numpy(), np.asarray(jgrid.ends))
    names = ("pos", "vel", "mass", "u", "alpha", "h", "alive", "u_c",
             "acc_ext", *derived)
    ours = _per_pid(p2.pid.numpy(), rung=rung_s.numpy(),
                    **{k: getattr(p2, k).numpy() for k in names})
    theirs = _per_pid(jp2.pid, rung=jrung,
                      **{k: getattr(jp2, k) for k in names})
    for name in ("rung", *names):
        assert ours[name].dtype == theirs[name].dtype, name
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    assert np.abs(ours["rho"][:300]).min() > 0.0      # carried, not zeroed
    assert not ours["rung"][320:].any()               # pad rows: rung 0
    # without carry_derived the derived fields still come back zeroed
    p3, _ = sort_particles(port_particles(jp), cfg, h_pad=1.2)
    assert not p3.rho.any() and not p3.acc.any() and bool((p3.omega == 1).all())


def test_sort_builds_no_tensor_from_host_data(monkeypatch):
    """A tensor made from a Python list on every sort is a host-to-device
    copy that makes the host wait for the card once per step: after the
    first sort on a device, `sort_particles` and `group_worklist` must
    build none (the plane offsets are kept per device)."""
    from summersph_tpu_torch.ops import sorted_grid

    cfg = SimConfig(fixed_h=2.0, neighbor_mode="sorted", window_group=32)
    st, _ = disc_ic(n=300, r_max=10.0, h0=2.0, cfg=cfg, seed=4, device="cpu")
    first = sort_particles(st.particles, cfg)[1]

    def refuse(*args, **kwargs):
        raise AssertionError("torch.tensor called on the sort path")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    rung = torch.zeros(st.particles.capacity, dtype=torch.int32)
    p2, again, _ = sort_particles(st.particles, cfg, carry_derived=True,
                                  extra=rung)
    group_worklist(p2.alive, cfg.window_group)
    assert torch.equal(first.starts, again.starts)
    assert (sorted_grid._plane_offsets(torch.device("cpu"))
            is sorted_grid._plane_offsets(torch.device("cpu")))


def test_variable_h_sort_reads_nothing_on_the_host():
    """The quantile cell of the variable-h sort (cfg.cell_h_quantile < 1)
    picks its entry of the sorted h by a device index: indexing with a 0-d
    tensor would read it on the host (`aten::item`), one wait for the card
    per step."""
    from torch.profiler import ProfilerActivity, profile

    cfg = SimConfig(fixed_h=None, neighbor_mode="sorted", window_group=32,
                    cell_h_quantile=0.9)
    st, _ = disc_ic(n=300, r_max=10.0, h0=1.5, cfg=cfg, seed=4, device="cpu")
    p = st.particles
    p = p.replace(h=p.h * (1.0 + torch.arange(p.capacity) / p.capacity))
    rung = torch.zeros(p.capacity, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p2, grid, _ = sort_particles(p, cfg, h_pad=cfg.sort_h_pad,
                                     carry_derived=True, extra=rung)
        group_worklist(p2.alive, cfg.window_group)
    ops = {e.key for e in prof.key_averages()}
    assert "aten::sort" in ops
    assert not ops & {"aten::item", "aten::_local_scalar_dense"}
    # the 0.9 quantile of the live h, padded by sort_h_pad
    h_q = torch.sort(p.h[p.alive]).values[int(0.9 * (300 - 1))]
    assert float(grid.cell_size) == pytest.approx(
        2.0 * float(h_q) * cfg.sort_h_pad, rel=1e-6)


# -------------------------------------------------- gated plain versions

def _blob_state(var, dtype=torch.float32):
    """tests/test_blockstep.py's `_blob` as port particles, sorted, with a
    spread of h when `var`; returns (p2, grid, cfg)."""
    from test_blockstep import _blob
    from test_torch_config_state import port_particles

    jp = _blob()
    if var:
        import jax.numpy as jnp
        h = 1.0 + 0.15 * np.random.default_rng(2).random(jp.capacity)
        jp = jp.replace(h=jnp.asarray(h, jnp.float32))
    cfg = SimConfig(fixed_h=None if var else 1.0, neighbor_mode="sorted",
                    use_pallas=True, sorted_block=128, window_group=32,
                    pallas_window=256, pallas_fetch_window=512,
                    window_blocks=3)
    p = port_particles(jp)
    if dtype == torch.float64:
        p = p.map(lambda a: a.double() if a.is_floating_point() else a)
    p2, grid = sort_particles(p, cfg)
    return jp, p2, grid, cfg


def _x_band(p2):
    """Rows with x < 3.5: clustered in the sort, about a third of them."""
    return p2.pos[:, 0] < 3.5


def _all_sums(p3, cfg, grid, split, active=None):
    """Every gated pass on one state: density, force, fused force, and the
    gravity sums over the same windows; a flat list of [N] tensors."""
    m = torch.where(p3.alive, p3.mass, 0.0)
    fused = cuda_pairs.force_sums(p3, cfg, grid, split, active)
    return [*cuda_pairs.density_sums(p3, cfg, grid, active),
            *cuda_pairs.force_sums(p3, cfg, grid, None, active),
            *fused[:5], *fused[5],
            *cuda_pairs.grav_short_sums(p3.pos, m, p3.h, grid, cfg, split,
                                        active)]


@pytest.mark.parametrize("var", [False, True], ids=["fixed_h", "var_h"])
def test_gated_plain_versions_equal_the_ungated(var):
    """A full worklist reproduces the ungated pass bit for bit; a partial
    one reproduces it on the rows of the listed groups and gives 0
    elsewhere.  All four force forms, both density forms and the gravity
    sums."""
    _, p2, grid, cfg = _blob_state(var)
    p3 = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    split = (torch.tensor(0.45), torch.tensor(2.0))
    wg = cfg.window_group
    ungated = _all_sums(p3, cfg, grid, split)
    assert all(bool(t.abs().max() > 0) for t in ungated
               if var or t is not ungated[1])

    full = _all_sums(p3, cfg, grid, split, group_worklist(p3.alive, wg))
    for a, b in zip(ungated, full):
        assert torch.equal(a, b)

    act = _x_band(p3)
    gate = group_worklist(act, wg)
    listed = torch.zeros(p3.capacity // wg, dtype=torch.bool)
    listed[gate[0][:int(gate[1])].long()] = True
    rows = listed.repeat_interleave(wg)
    assert 0 < int(gate[1]) < listed.shape[0] and bool(rows[act].all())
    for a, b in zip(ungated, _all_sums(p3, cfg, grid, split, gate)):
        assert torch.equal(a[rows], b[rows])
        assert not b[~rows].any()
    # an empty worklist computes nothing
    none = group_worklist(torch.zeros_like(act), wg)
    assert all(not t.any() for t in _all_sums(p3, cfg, grid, split, none))


@pytest.mark.parametrize("var", [False, True], ids=["fixed_h", "var_h"])
def test_gated_pair_eval_matches_pallas_interpret(var):
    """`pair_eval(active, act_mask)` against the JAX gated Pallas kernels in
    interpret mode on a state whose carried rho and omega are stale (1.1x
    and 0.9x a fresh evaluation): active rows get fresh sums that read
    their inactive neighbours' stale values, inactive rows keep theirs, and
    the rates are exactly 0 outside the mask."""
    import jax.numpy as jnp
    from summersph_tpu.blockstep import group_worklist as jax_worklist
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops.pallas_pairs import (pallas_pair_eval,
                                                window_overflow)
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort

    jp, p2, grid, cfg = _blob_state(var)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "fixed_h", "neighbor_mode", "use_pallas", "sorted_block",
        "window_group", "pallas_window", "pallas_fetch_window",
        "window_blocks")}, pallas_interpret=True)
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(window_overflow(jgrid, jcfg)) == 0
    fresh = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    stale = fresh.replace(rho=1.1 * fresh.rho, omega=0.9 * fresh.omega)
    # the same stale rho and omega on the JAX side, row by pid (one
    # interpret-mode evaluation instead of two)
    by_pid = np.argsort(stale.pid.numpy())[np.asarray(jp2.pid)]
    jstale = jp2.replace(rho=jnp.asarray(stale.rho.numpy()[by_pid]),
                         omega=jnp.asarray(stale.omega.numpy()[by_pid]))
    jact = jstale.pos[:, 0] < 3.5
    jout = pallas_pair_eval(
        jstale, jcfg, jgrid, interpret=True,
        active=jax_worklist(jact, jcfg.sorted_block), act_mask=jact)
    theirs = _per_pid(jout[0].pid, rho=jout[0].rho, omega=jout[0].omega,
                      pressure=jout[0].pressure, acc=jout[1], du=jout[2],
                      dalpha=jout[3], act=jact)

    act = _x_band(stale)
    out = cuda_pairs.pair_eval(stale, cfg, grid, active=group_worklist(
        act, cfg.window_group), act_mask=act)
    ours = _per_pid(out[0].pid.numpy(), rho=out[0].rho.numpy(),
                    omega=out[0].omega.numpy(),
                    pressure=out[0].pressure.numpy(), acc=out[1].numpy(),
                    du=out[2].numpy(), dalpha=out[3].numpy(),
                    act=act.numpy(), stale_rho=stale.rho.numpy(),
                    stale_omega=stale.omega.numpy())
    a = ours["act"]
    np.testing.assert_array_equal(a, theirs["act"])
    assert 0 < a.sum() < a.size
    for name in ("rho", "omega", "pressure"):
        np.testing.assert_allclose(ours[name], theirs[name], **RHO_TOL,
                                   err_msg=name)
    for name in ("acc", "du", "dalpha"):
        np.testing.assert_allclose(ours[name], theirs[name], **FORCE_TOL,
                                   err_msg=name)
        assert not ours[name][~a].any() and ours[name][a].any()
    # inactive rows keep exactly what they came with
    np.testing.assert_array_equal(ours["rho"][~a], ours["stale_rho"][~a])
    np.testing.assert_array_equal(ours["omega"][~a], ours["stale_omega"][~a])
    assert not np.any(ours["rho"][a] == ours["stale_rho"][a])


# ----------------------------- gated short-range gravity and h-iteration

def test_gated_pm_short_range_matches_jax():
    """`pm_short_range(active_rows=)`: the mask rides the gravity sort, the
    worklist is over that order, and inactive rows return exactly 0.
    Against the JAX gated kernel in interpret mode (float32), and on the
    active rows against the port's own ungated pass bit for bit."""
    import jax.numpy as jnp
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops import pm_gravity as jpm
    from summersph_tpu.state import Particles as JParticles
    from test_torch_config_state import port_particles

    rng = np.random.default_rng(0)
    n = 700                      # pads to 768 on the gravity sort
    jp = JParticles.create(pos=rng.uniform(-50, 50, (n, 3)),
                           vel=np.zeros((n, 3)), mass=np.full(n, 1.0 / n),
                           u=np.ones(n), h=2.0, dtype=jnp.float32)
    kw = dict(gravity="pm", neighbor_mode="sorted", sorted_block=128,
              window_group=32, use_pallas=True, grav_pallas_window=512,
              grav_pallas_fetch=768)
    # active: an octant, scattered through the SPH order of p
    act = np.asarray(jp.pos)[:, 0] + np.asarray(jp.pos)[:, 1] < -20.0
    jacc, j_over = jpm.pm_short_range(
        jp, JaxConfig(**kw, pallas_interpret=True), jnp.asarray(4.0),
        active_rows=jnp.asarray(act))
    assert int(j_over) == 0

    p, cfg = port_particles(jp), SimConfig(**kw)
    r_s = torch.tensor(4.0)
    acc, over = pm_gravity.pm_short_range(p, cfg, r_s,
                                          active_rows=torch.from_numpy(act))
    assert int(over) == 0 and 0 < act.sum() < n
    assert not acc[~torch.from_numpy(act)].any()
    scale = float(np.abs(np.asarray(jacc)).max())
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=2e-4,
                               atol=1e-5 * scale)
    ungated = pm_gravity.pm_short_range(p, cfg, r_s)[0]
    assert torch.equal(acc[torch.from_numpy(act)],
                       ungated[torch.from_numpy(act)])


def test_gated_h_iteration_matches_jax():
    """`update_smoothing(active, act_mask)` on the step's grid: only the
    masked rows iterate (through the gated re-sums), the rest keep their h;
    h, the unconverged count and the active rows' rho and Omega equal the
    JAX XLA engine's masked iteration in float64."""
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops.smoothing import update_smoothing
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
    from summersph_tpu.ops.sorted_grid import sorted_density
    from test_torch_config_state import port_particles
    from test_torch_smoothing_sinks import _kw, _off_target_lattice

    jcfg, cfg = JaxConfig(**_kw()), SimConfig(**_kw())
    jp = _off_target_lattice()
    jp2, jgrid = jax_sort(jp, jcfg, h_pad=jcfg.sort_h_pad)
    assert int(jgrid.n_window_overflow) == 0
    jact = jp2.pos[:, 0] < 3.0
    jout, jn = update_smoothing(sorted_density(jp2, jcfg, jgrid), jcfg,
                                grid=jgrid, act_mask=jact)

    p2, grid = sort_particles(port_particles(jp), cfg, h_pad=cfg.sort_h_pad)
    act = p2.pos[:, 0] < 3.0
    p3 = cuda_pairs.density(p2, cfg, grid)
    out, n_open = smoothing.update_smoothing(
        p3, cfg, grid=grid, active=group_worklist(act, cfg.window_group),
        act_mask=act)
    assert int(n_open) == int(jn) > 0
    ours = _per_pid(out.pid.numpy(), h=out.h.numpy(), rho=out.rho.numpy(),
                    omega=out.omega.numpy(), act=act.numpy(),
                    h0=p3.h.numpy(), rho0=p3.rho.numpy())
    theirs = _per_pid(jout.pid, h=jout.h, rho=jout.rho, omega=jout.omega,
                      act=jact)
    a = ours["act"]
    np.testing.assert_array_equal(a, theirs["act"])
    np.testing.assert_allclose(ours["h"], theirs["h"], rtol=1e-9)
    for name in ("rho", "omega"):
        np.testing.assert_allclose(ours[name][a], theirs[name][a],
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_array_equal(ours["h"][~a], ours["h0"][~a])
    np.testing.assert_array_equal(ours["rho"][~a], ours["rho0"][~a])
    assert np.all(ours["h"][a] != ours["h0"][a])
    with pytest.raises(ValueError):
        smoothing.update_smoothing(p3, cfg, act_mask=act)


# ------------------------------------------------------------- port only

def _disc(n, dt_bins, dt_init, **cfg_kw):
    """tests/test_blockstep.py's `_disc` (m_star = 1) in the port."""
    kw = dict(fixed_h=2.0, gravity="none", neighbor_mode="sorted",
              sorted_block=128, window_group=32, dt_init=dt_init,
              dt_min=1e-9, dt_max=1e-2, dt_bins=dt_bins)
    kw.update(cfg_kw)
    cfg = SimConfig(**kw)
    from summersph_tpu_torch.integrate import prime
    state, _ = disc_ic(n=n, r_max=10.0, m_disc=1.0, m_star=1.0, u0=0.1,
                       h0=2.0, cfg=cfg, seed=3, device="cpu")
    return prime(state, cfg), cfg


def test_all_rung0_matches_global_step():
    """dt far below every candidate puts everyone on rung 0: one binned
    base step is one global KDK step (the forces are evaluated at the same
    positions; only the drift in M increments reassociates the sum).
    tests/test_blockstep.py's tolerances."""
    from summersph_tpu_torch.integrate import step

    s0, cfg1 = _disc(512, dt_bins=1, dt_init=1e-6)
    sb, cfg3 = _disc(512, dt_bins=3, dt_init=1e-6)
    assert int(blockstep.assign_rungs(sb.particles, cfg3, sb.dt).max()) == 0
    o1, ob = step(s0, cfg1), blockstep.step_binned(sb, cfg3)
    a = _per_pid(o1.particles.pid.numpy(), x=o1.particles.pos.numpy(),
                 v=o1.particles.vel.numpy(), u=o1.particles.u.numpy())
    b = _per_pid(ob.particles.pid.numpy(), x=ob.particles.pos.numpy(),
                 v=ob.particles.vel.numpy(), u=ob.particles.u.numpy())
    np.testing.assert_allclose(a["x"], b["x"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(a["v"], b["v"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(a["u"], b["u"], rtol=2e-5, atol=1e-7)
    assert float(o1.t) == pytest.approx(float(ob.t), rel=1e-6)
    assert ob.particles.capacity == 512


@pytest.mark.parametrize("change,match", [
    (dict(dt_bins=11), "supported range is 1-10"),
    (dict(neighbor_mode="grid"), "requires the sorted engine"),
    (dict(reuse_forces=False), "requires reuse_forces"),
    (dict(gravity="direct"), "supports gravity in"),
    (dict(decomp="slab"), "single-chip"),
    (dict(pm_every=4, neighbor_mode="grid"), "held long-range PM force"),
    (dict(grav_fuse_short=True, use_pallas=False),
     "short-range gravity fused"),
    (dict(grav_fuse_short=True, use_pallas=True, neighbor_mode="dense"),
     "short-range gravity fused")])
def test_unsupported_config_errors(change, match):
    cfg = SimConfig(fixed_h=2.0, neighbor_mode="sorted", dt_bins=3)
    check_supported(cfg)
    with pytest.raises(ValueError, match=match):
        check_supported(cfg.with_(**change))
    st, _ = disc_ic(n=64, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        blockstep.step_binned(st, cfg.with_(**change))


def test_package_exports_step_binned():
    import summersph_tpu_torch

    assert summersph_tpu_torch.step_binned is blockstep.step_binned
    assert "step_binned" in summersph_tpu_torch.__all__


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("var", [False, True], ids=["fixed_h", "var_h"])
def test_gated_cuda_kernels_equal_the_ungated(cuda_device, var):
    """On the card each of the seven gated kernels equals its ungated form
    bit for bit: everywhere with a full worklist, on the listed groups'
    rows with a partial one, and reads 0 on the rest.  Each launch is
    counted in its own attribute, and a worklist on the wrong device or of
    the wrong type is refused."""
    from test_torch_pairs import _collapse_sorted, _small_disc

    p2, grid, cfg = (_collapse_sorted if var else _small_disc)(
        cuda_device, n=32768)
    p3 = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    r_s = pm_gravity.pm_geometry(p3, cfg.with_(gravity="pm"))[2]
    split = (r_s, 4.5 * r_s)
    wg = cfg.window_group
    counters = cuda_pairs.launch_counters()
    before = [getattr(w, a) for w, a in counters]
    ungated = _all_sums(p3, cfg, grid, split)
    full = _all_sums(p3, cfg, grid, split, group_worklist(p3.alive, wg))
    act = p3.pos[:, 0] < p3.pos[p3.alive, 0].median()
    gate = group_worklist(act, wg)
    part = _all_sums(p3, cfg, grid, split, gate)
    torch.cuda.synchronize()
    after = [getattr(w, a) for w, a in counters]
    v = "var_" if var else ""
    expect = {("density_sums", v + "launches"): 1,
              ("density_sums", v + "gated_launches"): 2,
              ("force_sums", v + "launches"): 1,
              ("force_sums", v + "gated_launches"): 2,
              ("force_sums", v + "fused_launches"): 1,
              ("force_sums", v + "fused_gated_launches"): 2,
              ("grav_short_sums", "launches"): 1,
              ("grav_short_sums", "gated_launches"): 2}
    for (w, a), n0, n1 in zip(counters, before, after):
        assert n1 - n0 == expect.get((w.__name__, a), 0), (w.__name__, a)

    listed = torch.zeros(p3.capacity // wg, dtype=torch.bool,
                         device=cuda_device)
    listed[gate[0][:int(gate[1])].long()] = True
    rows = listed.repeat_interleave(wg)
    assert 0 < int(gate[1]) < listed.shape[0]
    for a, b, c in zip(ungated, full, part):
        assert torch.equal(a, b)
        assert torch.equal(a[rows], c[rows])
        assert not c[~rows].any()
    with pytest.raises(ValueError):
        cuda_pairs.density_sums(p3, cfg, grid, (gate[0].cpu(), gate[1]))
    with pytest.raises(ValueError):
        cuda_pairs.density_sums(p3, cfg, grid, (gate[0].long(), gate[1]))
