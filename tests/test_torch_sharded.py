"""Multi-device runs of the port in gather mode (`summersph_tpu_torch.parallel`)
and the row-slab form of the pair passes.

The port's ranks are gloo processes on the CPU, spawned with a `file://`
rendezvous in the test's temporary directory; each caps torch's threads
at one and gives up on a collective after 60 s.  They are held per pid,
at tests/test_sharding.py's tolerances, against JAX's `shard_map` on 4 of
the 8 virtual CPU devices that tests/conftest.py sets up, and against the
port's own single-device run; the JAX side runs the same states in
float64.  The module's top level imports torch, numpy and the port only:
the spawned ranks import it to find their entry point, and JAX is
imported inside the tests.

The `gpu` test holds the row-slab kernels on the card: four slabs laid
end to end equal the whole launch bit for bit.  It skips without a card;
on the card's machine, without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sharded.py
"""

import dataclasses
import os
import pickle
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import init_carries, run_steps
from summersph_tpu_torch.ops import cuda_pairs
from summersph_tpu_torch.ops.pm_gravity import gravity_sort, pm_geometry
from summersph_tpu_torch.ops.sinks import create_sinks
from summersph_tpu_torch.ops.sorted_grid import sort_particles
from summersph_tpu_torch.parallel import (gather_particles, gather_state,
                                          make_mesh, make_sharded_prime,
                                          make_sharded_run_steps,
                                          make_sharded_step,
                                          pad_state_to_devices, shard_state,
                                          sharded_run_until, state_specs)
from summersph_tpu_torch.parallel.comm import (axis_index, axis_size, pmax,
                                               pmin, psum)
from summersph_tpu_torch.state import Particles, Sinks

# tests/test_sharding.py's tolerances
POS_TOL = dict(rtol=2e-5, atol=1e-6)
VEL_TOL = dict(rtol=2e-4, atol=1e-5)
RHO_TOL = dict(rtol=1e-4, atol=0.0)
H_TOL = dict(rtol=1e-4, atol=0.0)
SINK_MASS_TOL = dict(rtol=1e-5, atol=0.0)
DT_TOL = dict(rtol=1e-6, atol=0.0)


# ------------------------------------------------------------- the ranks

def _collectives(mesh):
    """The collectives a test holds exactly: a particle gather whose ids
    lie above 2^24 (they ride a float32 buffer by their bits), sink
    creation with one candidate of the same density on each rank, and the
    reductions and axis queries."""
    n = 128
    base = Particles.zeros(n, torch.float32, "cpu")
    pid = (1 << 24) + 1 + 2 * torch.arange(n, dtype=torch.int32) \
        + mesh.rank * 2 * n
    alive = torch.arange(n) % 3 != mesh.rank
    mine = base.replace(pid=pid, alive=alive,
                        mass=torch.full((n,), 0.5 + mesh.rank))
    got = gather_particles(mine, mesh)

    cfg = SimConfig(fixed_h=None, sink_create_density=1.0)
    one = Particles.create(pos=[[10.0 * (mesh.rank + 1), 0.0, 0.0]],
                           vel=[[1.0 + mesh.rank, 0.0, 0.0]], mass=1.0,
                           u=1.0, h=0.5, device="cpu")
    s, full = create_sinks(one, Sinks.zeros(2, device="cpu"), cfg,
                           axis_name=mesh)
    x = torch.tensor([mesh.rank, -mesh.rank], dtype=torch.int32)
    return {"pid": got.pid.numpy(), "alive": got.alive.numpy(),
            "mass": got.mass.numpy(), "sink_pos": s.pos.numpy(),
            "sink_vel": s.vel.numpy(), "sink_alive": s.alive.numpy(),
            "slots_full": int(full), "psum": psum(x, mesh).numpy(),
            "pmin": pmin(x, mesh).numpy(), "pmax": pmax(x, mesh).numpy(),
            "x": x.numpy(), "index": axis_index(mesh),
            "size": axis_size(mesh)}


def _run_job(job, mesh):
    """One sharded run of a global state: pad, shard, (prime,) step,
    run_steps or run until a time, gather."""
    if job["kind"] == "collectives":
        return _collectives(mesh)
    cfg = SimConfig(**job["cfg"])
    st = tstate.from_numpy(job["state"], device="cpu")
    st = shard_state(pad_state_to_devices(init_carries(st, cfg), mesh.size),
                     mesh)
    if job.get("prime"):
        st = make_sharded_prime(cfg, mesh)(st)
    if job["kind"] == "step":
        st = make_sharded_step(cfg, mesh)(st)
    elif job["kind"] == "until":
        st = sharded_run_until(st, T_STOP, cfg, mesh,
                               steps_per_sync=job["steps"])
    else:
        st = make_sharded_run_steps(cfg, mesh, n_steps=job["steps"])(st)
    return tstate.to_numpy(gather_state(st, mesh))


def _rank_main(rank, world, init_file, jobs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(world, device="cpu")
        results = {name: _run_job(job, mesh) for name, job in jobs.items()}
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, jobs, tmp_dir):
    mp.spawn(_rank_main, args=(world, str(tmp_dir / "rendezvous"), jobs,
                               str(tmp_dir)), nprocs=world, join=True)
    with open(tmp_dir / "results.pkl", "rb") as f:
        return pickle.load(f)


# ------------------------------------------------------- the three states

def _tiny_kw(gravity, fixed_h):
    """tests/test_sharding.py's `_tiny_state` config, in float64."""
    return dict(fixed_h=fixed_h, gravity=gravity, neighbor_mode="grid",
                gamma=1.4, eta=1.2, bounding_size=1500.0, cell_cap=32,
                sink_capacity=4, h_iter_max=3, dt_init=1e-4,
                dtype="float64")


# the sorted engine of tests/test_sharding.py, JAX's XLA form
SORTED_KW = dict(neighbor_mode="sorted", use_pallas=False, sorted_block=128,
                 window_group=32, window_blocks=3, grav_window_blocks=3,
                 grav_grid=32)

# Case (c) runs until this time in one segment of 3 steps (t = 0 at the
# start, dt_init 1e-4).
T_STOP = 2e-4

CASES = {
    # (a) the 'grid' config: direct gravity, variable h, one step.  The
    # port runs it on the sorted engine, whose h-iteration caps h at
    # 1.25 x h_max under 'grid' as JAX's hashed grid does; h reaches the
    # cap here.
    "grid_direct_var_h": (_tiny_kw("direct", None), {}, "step", 1, 96),
    # (b) the sorted engine with TreePM and fixed h, one step
    "sorted_pm_fixed_h": (_tiny_kw("pm", 20.0), SORTED_KW, "step", 1, 96),
    # (c) variable h with a fat sink, run until T_STOP in segments of 3
    # steps, with enough particles (448 of 512 rows) that the live rows
    # span all four ranks' slabs
    "sorted_pm_var_h_sink": (_tiny_kw("pm", None), SORTED_KW, "until", 3,
                             448),
    # (d) (b) with block timesteps asked for, run until T_STOP: on a mesh
    # both packages take global steps
    "sorted_pm_fixed_h_dt_bins": (_tiny_kw("pm", 20.0),
                                  {**SORTED_KW, "dt_bins": 2}, "until", 3,
                                  96),
}


def _jax_state(name):
    """The JAX state and config of a case: test_sharding's disc (seed 3),
    h = 20 with variable h, the fat sink of (c), padded for 4 devices."""
    import jax.numpy as jnp
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.models.disc import disc_ic as jax_disc_ic
    from summersph_tpu.parallel import pad_state_to_devices as jax_pad

    kw, over, _, _, n = CASES[name]
    cfg = JaxConfig(**kw).with_(**over)
    state, _ = jax_disc_ic(n=n, r_max=50.0, m_star=1.0, h0=20.0,
                           rotation="keplerian", capacity=n,
                           sink_capacity=4, cfg=cfg, seed=3)
    if kw["fixed_h"] is None:
        state = state.replace(particles=state.particles.replace(
            h=jnp.full_like(state.particles.h, 20.0)))
    if name == "sorted_pm_var_h_sink":
        state = state.replace(sinks=state.sinks.replace(radius=jnp.where(
            state.sinks.alive, 30.0, state.sinks.radius)))
    return jax_pad(state, 4), cfg


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The port's runs of the three cases on 4 gloo ranks, of case (c)'s
    3 steps through `make_sharded_run_steps` and the collectives on 2, and
    the numpy states they started from."""
    from test_torch_config_state import jax_state_dict

    states = {name: jax_state_dict(_jax_state(name)[0]) for name in CASES}
    jobs = {name: {"kind": kind, "steps": steps, "state": states[name],
                   "cfg": {**kw, **over}}
            for name, (kw, over, kind, steps, _) in CASES.items()}
    d4 = _spawn(4, jobs, tmp_path_factory.mktemp("d4"))
    d2 = _spawn(2, {"sorted_pm_var_h_sink": {**jobs["sorted_pm_var_h_sink"],
                                             "kind": "run"},
                    "collectives": {"kind": "collectives"}},
                tmp_path_factory.mktemp("d2"))
    return {"states": states, "jobs": jobs, 4: d4, 2: d2}


def _by_pid(particles):
    order = np.argsort(particles["pid"])
    return {k: v[order] for k, v in particles.items()}


def _hold(ours, theirs, label):
    """A gathered port state against a reference state dict, per pid, at
    tests/test_sharding.py's tolerances."""
    a, b = _by_pid(ours["particles"]), _by_pid(theirs["particles"])
    np.testing.assert_array_equal(a["pid"], b["pid"], err_msg=label)
    np.testing.assert_array_equal(a["alive"], b["alive"], err_msg=label)
    for name, tol in (("pos", POS_TOL), ("vel", VEL_TOL), ("rho", RHO_TOL),
                      ("h", H_TOL)):
        live = a["alive"]
        np.testing.assert_allclose(a[name][live], b[name][live], **tol,
                                   err_msg=f"{label}: {name}")
    np.testing.assert_allclose(ours["sinks"]["mass"], theirs["sinks"]["mass"],
                               **SINK_MASS_TOL, err_msg=f"{label}: sinks")
    assert float(ours["t"]) == float(theirs["t"]), label
    np.testing.assert_allclose(float(ours["dt"]), float(theirs["dt"]),
                               **DT_TOL, err_msg=f"{label}: dt")


def _jax_sharded(name):
    """The JAX package's run of a case under shard_map on 4 devices."""
    from summersph_tpu.parallel import (make_mesh as jax_mesh,
                                        make_sharded_step as jax_step,
                                        shard_state as jax_shard,
                                        sharded_run_until as jax_until)
    from test_torch_config_state import jax_state_dict

    state, cfg = _jax_state(name)
    mesh = jax_mesh(4)
    state = jax_shard(state, mesh)
    _, _, kind, steps, _ = CASES[name]
    if kind == "step":
        return jax_state_dict(jax_step(cfg, mesh)(state))
    return jax_state_dict(jax_until(state, T_STOP, cfg, mesh,
                                    steps_per_sync=steps))


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax_shard_map(sharded_runs, name):
    """(a) the 'grid' config, which the port runs on the sharded sorted
    engine, (b) the sorted engine with TreePM and fixed h, (c) variable h
    with accretion, `sharded_run_until` to T_STOP, (d) (b) with dt_bins 2
    run until T_STOP: 4 gloo ranks against JAX's shard_map on 4 devices,
    per pid."""
    theirs = _jax_sharded(name)
    ours = sharded_runs[4][name]
    _hold(ours, theirs, name)
    if name == "sorted_pm_var_h_sink":
        assert float(ours["t"]) >= T_STOP
        # accretion fired, across rank boundaries, and conserved mass
        start = sharded_runs["states"][name]
        n_alive = int(ours["particles"]["alive"].sum())
        assert n_alive == int(theirs["particles"]["alive"].sum())
        assert n_alive < int(start["particles"]["alive"].sum())
        m0 = (start["particles"]["mass"][start["particles"]["alive"]].sum()
              + start["sinks"]["mass"].sum())
        p = ours["particles"]
        m1 = p["mass"][p["alive"]].sum() + ours["sinks"]["mass"].sum()
        np.testing.assert_allclose(m1, m0, rtol=1e-12)
        # the accreted particles lay in more than one rank's slab of the
        # sorted order (the first step's sort, taken at the start)
        cfg = SimConfig(**sharded_runs["jobs"][name]["cfg"])
        p0, _ = sort_particles(tstate.from_numpy(start, "cpu").particles, cfg,
                               h_pad=cfg.sort_h_pad)
        # (pids are 0..n-1: a pid is its index in a by-pid array)
        accreted = start["particles"]["alive"] & ~_by_pid(p)["alive"]
        slab = np.arange(p0.capacity) // (p0.capacity // 4)
        ranks = set(slab[accreted[p0.pid.numpy()]].tolist())
        assert len(ranks) > 1, ranks


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_port_on_one_device(sharded_runs, world):
    """Case (c) on 2 ranks (`make_sharded_run_steps`, 3 steps) and on 4
    (`sharded_run_until`, one segment of 3 steps) against the port's
    single-device run_steps of 3 steps from the same padded state, per
    pid."""
    job = sharded_runs["jobs"]["sorted_pm_var_h_sink"]
    cfg = SimConfig(**job["cfg"])
    ref = run_steps(tstate.from_numpy(job["state"], device="cpu"), cfg,
                    job["steps"])
    _hold(sharded_runs[world]["sorted_pm_var_h_sink"], tstate.to_numpy(ref),
          f"{world} ranks")


def test_particle_gather_keeps_ids_above_2_24(sharded_runs):
    """pid and alive ride the float32 gather buffer by their bits: ids
    above 2^24, which float32 cannot hold as values, come back exact."""
    got = sharded_runs[2]["collectives"]
    n = 128
    pid = np.concatenate([(1 << 24) + 1 + 2 * np.arange(n) + r * 2 * n
                          for r in range(2)])
    alive = np.concatenate([np.arange(n) % 3 != r for r in range(2)])
    assert got["pid"].dtype == np.int32 and got["alive"].dtype == np.bool_
    np.testing.assert_array_equal(got["pid"], pid)
    np.testing.assert_array_equal(got["alive"], alive)
    np.testing.assert_array_equal(got["mass"], np.repeat([0.5, 1.5], n))


def test_reductions_and_axis_queries(sharded_runs):
    """psum, pmin and pmax reduce elementwise over the ranks, exact on
    integers; axis_index and axis_size give rank 0's place and the
    rank count."""
    got = sharded_runs[2]["collectives"]
    np.testing.assert_array_equal(got["psum"], [1, -1])
    np.testing.assert_array_equal(got["pmin"], [0, -1])
    np.testing.assert_array_equal(got["pmax"], [1, 0])
    np.testing.assert_array_equal(got["x"], [0, 0])  # the input is kept
    assert (got["index"], got["size"]) == (0, 2)


def test_state_specs_match_jax():
    """Where each field of a state lives, as the JAX package's
    PartitionSpecs say: split by rows on the axis, replicated, or
    absent, for each combination of the optional carries."""
    from summersph_tpu.parallel import state_specs as jax_specs

    def flat(spec):
        return None if spec is None else tuple(spec)

    for kahan_u in (False, True):
        for pm_held in (False, True):
            ours = state_specs("dp", kahan_u=kahan_u, pm_held=pm_held)
            theirs = jax_specs("dp", kahan_u=kahan_u, pm_held=pm_held)
            for part in ("particles", "sinks"):
                a, b = getattr(ours, part), getattr(theirs, part)
                for f in dataclasses.fields(a):
                    assert (flat(getattr(a, f.name))
                            == flat(getattr(b, f.name, None))), f.name
            for f in ("t", "dt", "stats", "pm_r_s"):
                assert flat(getattr(ours, f)) == flat(getattr(theirs, f)), f


def test_create_sinks_ties_go_to_the_first_rank(sharded_runs):
    """Each rank's only candidate has the same density: every rank creates
    the sink at rank 0's particle, as jnp.argmax takes the first maximum."""
    got = sharded_runs[2]["collectives"]
    np.testing.assert_array_equal(got["sink_alive"], [True, False])
    np.testing.assert_array_equal(got["sink_pos"][0], [10.0, 0.0, 0.0])
    np.testing.assert_array_equal(got["sink_vel"][0], [1.0, 0.0, 0.0])
    assert got["slots_full"] == 0


# ------------------------------------------------------ the row slabs

def _slab_states(device, n, dtype=torch.float64):
    """A disc with fixed h and one with variable h (h from 0.6 to 1.8 x
    h0, by radius), sorted, and the gravity sort of the first."""
    from summersph_tpu_torch.models.disc import disc_ic

    out = {}
    for fixed_h in (2.5, None):
        cfg = SimConfig(fixed_h=fixed_h, neighbor_mode="sorted",
                        sorted_block=128, window_group=32, gravity="pm",
                        grav_grid=32, cell_h_quantile=1.0,
                        dtype="float64" if dtype == torch.float64
                        else "float32")
        st, _ = disc_ic(n=n, r_max=40.0, seed=2, cfg=cfg, h0=2.5,
                        device=device)
        p = st.particles
        if fixed_h is None:
            r = torch.linalg.norm(p.pos, dim=1)
            p = p.replace(h=2.5 * (0.6 + 1.2 * r / torch.amax(r)))
        p2, grid = sort_particles(p, cfg, h_pad=1.0)
        out["fixed" if fixed_h else "var"] = (p2, grid, cfg)
    return out


def _slabs(call, n, parts=4):
    """`call(offset, n_rows)` over `parts` equal slabs, laid end to end."""
    nl = n // parts
    outs = [call(k * nl, nl) for k in range(parts)]
    return tuple(torch.cat([o[c] for o in outs]) for c in range(len(outs[0])))


def _slab_cases(states):
    """(name, whole-set call, slab call) of every row-slab form."""
    cases = []
    for h in ("fixed", "var"):
        p2, grid, cfg = states[h]
        pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]

        def rows(p, off, nl):
            return (p.map(lambda a: a[off:off + nl]), off)

        cases.append((f"density {h} h",
                      lambda p2=p2, grid=grid, cfg=cfg:
                      cuda_pairs.density_sums(p2, cfg, grid),
                      lambda off, nl, p2=p2, grid=grid, cfg=cfg:
                      cuda_pairs.density_sums(p2, cfg, grid,
                                              rows=rows(p2, off, nl))))
        cases.append((f"force {h} h",
                      lambda pd=pd, grid=grid, cfg=cfg:
                      cuda_pairs.force_sums(pd, cfg, grid),
                      lambda off, nl, pd=pd, grid=grid, cfg=cfg:
                      cuda_pairs.force_sums(pd, cfg, grid,
                                            rows=rows(pd, off, nl))))
    p2, _, cfg = states["fixed"]
    pos, m, hs, ggrid, _, split = gravity_sort(p2, cfg,
                                               pm_geometry(p2, cfg)[2])
    cases.append(("grav_short",
                  lambda: cuda_pairs.grav_short_sums(pos, m, hs, ggrid, cfg,
                                                     split),
                  lambda off, nl: cuda_pairs.grav_short_sums(
                      pos, m, hs, ggrid, cfg, split, rows=(off, nl))))
    return cases


@pytest.fixture(scope="module")
def cpu_slab_cases():
    states = _slab_states("cpu", 2048)
    return states["fixed"][0].capacity, _slab_cases(states)


@pytest.mark.parametrize("which", range(5))
def test_plain_row_slabs_equal_the_whole_set(cpu_slab_cases, which):
    """The plain versions' row-slab form: 4 slabs laid end to end equal
    the whole-set sums bit for bit (density and force with fixed and
    variable h, the short-range gravity on the gravity sort)."""
    n, cases = cpu_slab_cases
    name, whole, slab = cases[which]
    for c, (a, b) in enumerate(zip(whole(), _slabs(slab, n))):
        assert torch.equal(a, b), f"{name} output {c}"


def test_row_slab_density_takes_the_rows_h():
    """The density's row slab reads h from p_rows (the h-iteration moves
    the rows' h alone) and the columns' positions and masses from p."""
    states = _slab_states("cpu", 1024)
    p2, grid, cfg = states["var"]
    off, nl = 256, 512
    q = p2.map(lambda a: a[off:off + nl])
    q = q.replace(h=q.h * 1.1)
    slab = cuda_pairs.density_sums(p2, cfg, grid, rows=(q, off))
    whole = cuda_pairs.density_sums(p2.replace(h=torch.cat(
        [p2.h[:off], q.h, p2.h[off + nl:]])), cfg, grid)
    for a, b in zip(slab, whole):
        assert torch.equal(a, b[off:off + nl])


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A mesh of this process alone: a gloo group of one rank on the CPU,
    destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rv'}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _one_rank_disc(mesh, cfg):
    from summersph_tpu_torch.models.disc import disc_ic

    st = disc_ic(n=96, h0=20.0, r_max=50.0, cfg=cfg, seed=3,
                 device="cpu")[0]
    return shard_state(pad_state_to_devices(st, 1), mesh)


def test_check_supported_refuses_only_slab_and_block_steps(one_rank_mesh):
    """On a mesh the port refuses no configuration (one rank here): the
    slab decomposition, the dense engine and block timesteps run; only an
    axis name that is no `parallel.Mesh` (a JAX axis name) is refused,
    with TypeError."""
    from summersph_tpu_torch.integrate import check_supported

    mesh = one_rank_mesh
    kw, over = CASES["sorted_pm_var_h_sink"][:2]
    cfg = SimConfig(**{**kw, **over})
    st = _one_rank_disc(mesh, cfg)
    for good in (dict(neighbor_mode="dense"),
                 dict(decomp="slab", halo_rows=128, grav_halo_rows=128),
                 dict(dt_bins=2),
                 dict(decomp="slab", halo_rows=128, grav_halo_rows=128,
                      dt_bins=2)):
        check_supported(cfg.with_(**good), mesh)
        out = make_sharded_step(cfg.with_(**good), mesh)(st)
        assert int(out.particles.n_alive) > 0, good
    with pytest.raises(TypeError):
        check_supported(cfg, "dp")


@pytest.mark.parametrize("pm_every", [1, 2])
def test_block_steps_on_a_mesh_take_global_steps(one_rank_mesh, pm_every):
    """With dt_bins 2 on a mesh, `make_sharded_prime`, `make_sharded_step`,
    `make_sharded_run_steps` and `sharded_run_until` take the global steps
    of dt_bins 1 on the same mesh, bit for bit per pid; with PM gravity
    the held far field is carried (acc_ext, pm_r_s), and with pm_every 2
    it is held between solves as with dt_bins 1."""
    mesh = one_rank_mesh
    kw, over = CASES["sorted_pm_var_h_sink"][:2]
    base = SimConfig(**{**kw, **over, "pm_every": pm_every})
    st = init_carries(_one_rank_disc(mesh, base), base.with_(dt_bins=2))
    assert st.particles.acc_ext is not None and st.pm_r_s is not None
    runs = {}
    for bins in (1, 2):
        cfg = base.with_(dt_bins=bins)
        primed = make_sharded_prime(cfg, mesh)(st)
        runs[bins] = {
            "step": make_sharded_step(cfg, mesh)(primed),
            "run_steps": make_sharded_run_steps(cfg, mesh, n_steps=3)(primed),
            "until": sharded_run_until(primed, T_STOP, cfg, mesh,
                                       steps_per_sync=2)}
    assert float(runs[2]["until"].t) >= T_STOP
    for how, out in runs[2].items():
        assert out.particles.acc_ext is not None and out.pm_r_s is not None
        ours = tstate.to_numpy(gather_state(out, mesh))
        ref = tstate.to_numpy(gather_state(runs[1][how], mesh))
        a, b = _by_pid(ours["particles"]), _by_pid(ref["particles"])
        for name in ("pid", "alive", "pos", "vel", "u", "rho", "h", "acc"):
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{how}: {name}")
        for name in ("t", "dt", "stats"):
            np.testing.assert_array_equal(ours[name], ref[name],
                                          err_msg=f"{how}: {name}")
        np.testing.assert_array_equal(ours["sinks"]["mass"],
                                      ref["sinks"]["mass"], err_msg=how)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_row_slabs_equal_the_whole_launch(cuda_device):
    """Each row-slab kernel over 4 slabs of a 131,072-particle disc equals
    the whole launch bit for bit."""
    n = 131072
    states = _slab_states(cuda_device, n, torch.float32)

    def rows_launches():
        return sum(getattr(w, a) for w, a in cuda_pairs.launch_counters()
                   if "rows_" in a)

    before = rows_launches()
    for name, whole, slab in _slab_cases(states):
        ref = whole()
        got = _slabs(slab, n)
        torch.cuda.synchronize()
        for c, (a, b) in enumerate(zip(ref, got)):
            assert torch.equal(a, b), f"{name} output {c}"
    assert rows_launches() - before == 5 * 4
