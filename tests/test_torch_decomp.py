"""The slab decomposition of the port (`cfg.decomp='slab'`,
`summersph_tpu_torch/parallel/decomp.py`), the `key_rows` form of the pair
passes and the pencil Poisson solve.

The port's ranks are gloo processes on the CPU, spawned once per module
(4 ranks, and 2 for the pencil solve and one run) with a `file://`
rendezvous in the test's temporary directory; each caps torch's threads
at one and gives up on a collective after 60 s.  They are held against
JAX's `shard_map` on 4 of the 8 virtual CPU devices of tests/conftest.py,
at tests/test_decomp.py's tolerances, per pid, and against the port's own
single-device run; every run is in float64.  The module's top level
imports torch, numpy and the port only: the spawned ranks import it to
find their entry point, and JAX is imported inside the tests.

The `gpu` test holds the key_rows kernels on the card against their plain
version and against the whole-set launch.  It skips without a card; on
the card's machine, without JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_decomp.py
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
from summersph_tpu_torch.integrate import init_carries, prime, run_steps, step
from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
from summersph_tpu_torch.ops.sorted_grid import SENTINEL_KEY, sort_particles
from summersph_tpu_torch.parallel import (gather_state, make_mesh,
                                          make_sharded_prime,
                                          make_sharded_run_steps,
                                          make_sharded_step,
                                          pad_state_to_devices, shard_state,
                                          sharded_run_until)
from summersph_tpu_torch.parallel import comm
from summersph_tpu_torch.parallel.decomp import (exchange_rim,
                                                 global_geometry,
                                                 redistribute,
                                                 slabs_in_process)
from summersph_tpu_torch.state import Particles

# tests/test_decomp.py's tolerances (:150-162, :190-199, :256)
FIELD_RTOL = 5e-6
VEL_TOL = dict(rtol=2e-4, atol=1e-5)
H_RTOL, SINK_RTOL, U_RTOL = 1e-5, 1e-6, 1e-5
T_STOP = 2e-4   # the variable-h case runs until here, segments of 3 steps
HALO = 128      # exchange_rim's rim in the rim test


# ------------------------------------------------------------- the ranks

def _shard(d: dict, mesh):
    """This rank's rows of a numpy particle dict, as Particles."""
    n = len(d["pid"]) // mesh.size
    lo = mesh.rank * n
    return Particles(**{k: torch.from_numpy(np.array(v[lo:lo + n]))
                        for k, v in d.items()})


def _job_redistribute(job, mesh):
    cfg = SimConfig(**job["cfg"])
    p = _shard(job["particles"], mesh)
    origin, cell = global_geometry(p, cfg, mesh)
    key, own, splitters, n_mis, n_over = redistribute(p, cfg, mesh, origin,
                                                      cell)
    out = {"key": key.numpy(), "pid": own.pid.numpy(),
           "alive": own.alive.numpy(), "u": own.u.numpy(),
           "splitters": splitters.numpy(), "bad": int(n_mis + n_over)}
    if job.get("halo"):
        rl, rr = exchange_rim(key, own, mesh, job["halo"])
        out.update(rl_key=rl["key"].numpy(), rr_key=rr["key"].numpy(),
                   rl_pid=rl["pid"].numpy(), rr_pid=rr["pid"].numpy())
    return out


def _job_run(job, mesh):
    """Pad, shard, prime (one step's drive) or not, then one step,
    run_steps or run until T_STOP (job["drive"]), gather; with
    job["bytes"] the collectives' result bytes of the last call instead."""
    cfg = SimConfig(**job["cfg"])
    st = tstate.from_numpy(job["state"], device="cpu")
    st = shard_state(pad_state_to_devices(init_carries(st, cfg), mesh.size),
                     mesh)
    if job["drive"] == "step":
        st = make_sharded_prime(cfg, mesh)(st)
    comm.reset_result_bytes()
    if job["drive"] == "step":
        st = make_sharded_step(cfg, mesh)(st)
    elif job["drive"] == "run":
        st = make_sharded_run_steps(cfg, mesh, n_steps=3)(st)
    else:
        st = sharded_run_until(st, T_STOP, cfg, mesh, steps_per_sync=3)
    if job.get("bytes"):
        return dict(comm.RESULT_BYTES)
    return tstate.to_numpy(gather_state(st, mesh))


def _job_pencil(job, mesh):
    cfg = SimConfig(**job["cfg"])
    before = pm_gravity.pm_long_range.pencil_solves
    acc = pm_gravity.pm_long_range(_shard(job["particles"], mesh), cfg,
                                   axis_name=mesh, decomp=True)[0]
    return {"acc": acc.numpy(),
            "pencil": pm_gravity.pm_long_range.pencil_solves - before}


JOBS = {"redistribute": _job_redistribute, "run": _job_run,
        "pencil": _job_pencil}


def _rank_main(rank, world, init_file, jobs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(world, device="cpu")
        results = {name: JOBS[job["kind"]](job, mesh)
                   for name, job in jobs.items()}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, jobs, tmp_dir):
    """Every rank's results: [rank] -> {job name: result}."""
    mp.spawn(_rank_main, args=(world, str(tmp_dir / "rendezvous"), jobs,
                               str(tmp_dir)), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------- the inputs

def _numpy(p: Particles) -> dict:
    """The present fields of a Particles as numpy arrays."""
    return {f.name: getattr(p, f.name).numpy()
            for f in dataclasses.fields(p) if getattr(p, f.name) is not None}


def _ball(n, seed, dead_frac):
    """tests/test_decomp.py's ball_particles, in float64, as a numpy
    particle dict (the port's field names) with u a per-particle tag."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10.0
    vel = rng.normal(size=(n, 3)) * 0.1
    u_tag = rng.random(n)
    alive = rng.random(n) > dead_frac
    p = Particles.create(pos=pos, vel=vel, mass=np.full(n, 1.0 / n), u=u_tag,
                         h=np.full(n, 1.0), device="cpu",
                         dtype=torch.float64)
    return _numpy(p.replace(alive=torch.from_numpy(alive)))


def _jax_particles(d):
    """A numpy particle dict as JAX Particles."""
    import jax.numpy as jnp
    from summersph_tpu.state import Particles as JaxParticles

    return JaxParticles(**{k: jnp.asarray(v) for k, v in d.items()})


# test_decomp.py's redistribution and rim configs, on 4 ranks
RED_CFG = dict(fixed_h=1.0, neighbor_mode="sorted", decomp="slab",
               migrate_rows=512, dtype="float64")


def _disc_kw(fixed_h=20.0, gravity="pm", **over):
    """tests/test_decomp.py's `_disc_state` config, in float64."""
    kw = dict(fixed_h=fixed_h, gravity=gravity, neighbor_mode="sorted",
              decomp="slab", halo_rows=128, grav_halo_rows=128, halo_hops=3,
              migrate_rows=128, sorted_block=128, window_group=32,
              window_blocks=3, grav_window_blocks=3, grav_grid=32,
              gamma=1.4, eta=1.2, bounding_size=1500.0, sink_capacity=4,
              h_iter_max=3, dt_init=1e-4, dtype="float64")
    kw.update(over)
    return kw


CASES = {
    # test_decomp_step_matches_single_device_pm: one PM step, fixed h
    "pm_step": (_disc_kw(), "step", False),
    # test_decomp_variable_h_multistep_accretion with the Kahan carry of
    # test_decomp_kahan_u_rides_redistribution: variable h, a fat sink,
    # TreePM, u_c riding, run until T_STOP in a segment of 3 steps from
    # the unprimed state (as tests/test_torch_sharded.py's case (c))
    "var_h": (_disc_kw(fixed_h=None, kahan_u=True), "until", True),
}


def _jax_state(kw, fat_sink=False, n=96):
    """The JAX state and config of test_decomp's disc (seed 3) with config
    `kw`, the sink made fat (radius 30) with `fat_sink`, padded for 4
    devices."""
    import jax.numpy as jnp
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.integrate import init_carries as jax_init
    from summersph_tpu.models.disc import disc_ic as jax_disc_ic
    from summersph_tpu.parallel import pad_state_to_devices as jax_pad

    cfg = JaxConfig(**kw)
    state, _ = jax_disc_ic(n=n, r_max=50.0, m_star=1.0, h0=20.0,
                           rotation="keplerian", capacity=n,
                           sink_capacity=4, cfg=cfg, seed=3)
    if fat_sink:
        state = state.replace(sinks=state.sinks.replace(radius=jnp.where(
            state.sinks.alive, 30.0, state.sinks.radius)))
    return jax_pad(jax_init(state, cfg), 4), cfg


def _case_state(name):
    kw, _, fat_sink = CASES[name]
    return _jax_state(kw, fat_sink)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's jobs on 4 gloo ranks and on 2, and their inputs."""
    from test_torch_config_state import jax_state_dict

    ball = _ball(4 * 512, seed=1, dead_frac=0.1)
    states = {name: jax_state_dict(_case_state(name)[0]) for name in CASES}
    rng = np.random.default_rng(7)
    n_p = 4 * 256
    pencil = Particles.create(
        pos=np.concatenate([rng.normal(0.0, 3.0, (n_p // 2, 3)),
                            rng.normal(6.0, 1.0, (n_p // 2, 3))]),
        vel=np.zeros((n_p, 3)), mass=rng.uniform(0.5, 1.5, n_p),
        u=np.full(n_p, 1.0), h=np.full(n_p, 1.0), device="cpu",
        dtype=torch.float64)
    pencil = _numpy(pencil)
    pencil_kw = dict(gravity="pm", grav_grid=16, grav_fft="matmul",
                     neighbor_mode="sorted", decomp="slab", dtype="float64")
    jobs4 = {
        "redistribute": {"kind": "redistribute", "particles": ball,
                         "cfg": RED_CFG, "halo": HALO},
        **{name: {"kind": "run", "state": states[name], "cfg": kw,
                  "drive": drive}
           for name, (kw, drive, _) in CASES.items()},
        "pencil": {"kind": "pencil", "particles": pencil, "cfg": pencil_kw},
        # 18 does not split over 4 ranks: the summed mesh, replicated
        "pencil_fallback": {"kind": "pencil", "particles": pencil,
                            "cfg": {**pencil_kw, "grav_grid": 18}},
    }
    bytes_kw = _disc_kw(gravity="none")
    for n in (1024, 2048):
        jobs4[f"bytes_slab_{n}"] = {
            "kind": "run", "cfg": bytes_kw, "drive": "step", "bytes": True,
            "state": jax_state_dict(_jax_state(bytes_kw, n=n)[0])}
    jobs4["bytes_gather_2048"] = {**jobs4["bytes_slab_2048"],
                                  "cfg": {**bytes_kw, "decomp": "gather"}}
    jobs2 = {"var_h": {**jobs4["var_h"], "drive": "run"},
             "pencil": jobs4["pencil"]}
    return {"ball": ball, "states": states, "pencil": (pencil, pencil_kw),
            4: _spawn(4, jobs4, tmp_path_factory.mktemp("d4")),
            2: _spawn(2, jobs2, tmp_path_factory.mktemp("d2"))}


def _jax_shard_map(body, out_specs, d):
    """body(p) under shard_map on 4 of the virtual devices, on the JAX
    particles of the numpy dict d."""
    import jax
    from jax.sharding import PartitionSpec as P
    from summersph_tpu.parallel import make_mesh as jax_mesh
    from summersph_tpu.parallel.sharded import _shard_map
    from summersph_tpu.state import Particles as JaxParticles

    spec = JaxParticles(**{f: P("dp") for f in
                           JaxParticles.__dataclass_fields__
                           if f not in ("u_c", "acc_ext")})
    fn = jax.jit(_shard_map(body, jax_mesh(4), (spec,), out_specs))
    return fn(_jax_particles(d))


# ------------------------------------------------- redistribution, rims

@pytest.fixture(scope="module")
def jax_redistribute(ranks):
    """JAX's redistribute and exchange_rim of the same ball on 4 devices:
    per device key, pid, alive, splitters and the rims' keys and pids."""
    import jax
    from jax.sharding import PartitionSpec as P
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.parallel.decomp import (exchange_rim as j_rim,
                                               global_geometry as j_geo,
                                               redistribute as j_red)

    cfg = JaxConfig(**RED_CFG)

    def body(p):
        origin, cell = j_geo(p, cfg, "dp")
        key, own, splitters, _, _ = j_red(p, cfg, "dp", origin, cell)
        rl, rr = j_rim(key, own, "dp", HALO)
        return (key, own.pid, splitters[None], rl["key"], rr["key"],
                rl["pid"], rr["pid"])

    out = _jax_shard_map(body, (P("dp"),) * 7, ranks["ball"])
    names = ("key", "pid", "splitters", "rl_key", "rr_key", "rl_pid",
             "rr_pid")
    return {k: np.asarray(v).reshape(4, -1) for k, v in zip(names, out)}


def test_redistribute_matches_jax(ranks, jax_redistribute):
    """test_decomp's redistribution (:36-104) on 4 ranks: every live
    particle owned once, each slab sorted, the slabs rank-ordered and
    key-disjoint, nothing mis-owned or dropped, the fields riding with
    their particle; and the same splitters as JAX's, exactly, hence the
    same slabs, key for key and pid for pid."""
    got = [r["redistribute"] for r in ranks[4]]
    ball = ranks["ball"]
    assert all(g["bad"] == 0 for g in got)
    pid_in = np.sort(ball["pid"][ball["alive"]])
    pid_out = np.sort(np.concatenate([g["pid"][g["alive"]] for g in got]))
    np.testing.assert_array_equal(pid_out, pid_in)
    for d, g in enumerate(got):
        kd = g["key"][g["alive"]]
        assert (np.diff(kd) >= 0).all()
        if d:
            prev = got[d - 1]["key"][got[d - 1]["alive"]]
            assert prev.max() <= kd.min()
        np.testing.assert_array_equal(g["u"][g["alive"]],
                                      ball["u"][g["pid"][g["alive"]]])
        np.testing.assert_array_equal(g["splitters"],
                                      jax_redistribute["splitters"][d])
        live = g["key"] != SENTINEL_KEY
        np.testing.assert_array_equal(g["key"][live],
                                      jax_redistribute["key"][d][live])
        np.testing.assert_array_equal(g["pid"][live],
                                      jax_redistribute["pid"][d][live])


def test_exchange_rim_matches_jax(ranks, jax_redistribute):
    """test_decomp's rim test (:314-358): each rank's rims are its rank
    neighbours' boundary rows (the edge ranks' outer rims dead), and the
    rims equal JAX's, key for key and pid for pid on the live rows."""
    got = [r["redistribute"] for r in ranks[4]]
    for d, g in enumerate(got):
        if d == 0:
            assert (g["rl_key"] == SENTINEL_KEY).all()
        else:
            nb = got[d - 1]
            nl = int((nb["key"] != SENTINEL_KEY).sum())
            lo = max(nl - HALO, 0)
            np.testing.assert_array_equal(g["rl_pid"][:min(HALO, nl)],
                                          nb["pid"][lo:lo + min(HALO, nl)])
        if d == 3:
            assert (g["rr_key"] == SENTINEL_KEY).all()
        else:
            nb = got[d + 1]
            nr = int((nb["key"] != SENTINEL_KEY).sum())
            np.testing.assert_array_equal(g["rr_pid"][:min(HALO, nr)],
                                          nb["pid"][:min(HALO, nr)])
        for side in ("rl", "rr"):
            live = g[f"{side}_key"] != SENTINEL_KEY
            for what in ("key", "pid"):
                np.testing.assert_array_equal(
                    g[f"{side}_{what}"][live],
                    jax_redistribute[f"{side}_{what}"][d][live])


# --------------------------------------------------------------- the runs

def _jax_run(name):
    """JAX's slab run of a case under shard_map on 4 devices."""
    from summersph_tpu.parallel import (make_mesh as jax_mesh,
                                        make_sharded_prime as jax_prime,
                                        make_sharded_step as jax_step,
                                        shard_state as jax_shard,
                                        sharded_run_until as jax_until)
    from test_torch_config_state import jax_state_dict

    state, cfg = _case_state(name)
    mesh = jax_mesh(4)
    state = jax_shard(state, mesh)
    if CASES[name][1] == "step":
        state = jax_prime(cfg, mesh)(state)
        return jax_state_dict(jax_step(cfg, mesh)(state))
    return jax_state_dict(jax_until(state, T_STOP, cfg, mesh,
                                    steps_per_sync=3))


def _by_pid(d):
    p = d["particles"]
    live = p["alive"]
    order = np.argsort(p["pid"][live])
    return {k: v[live][order] for k, v in p.items()}


def _mass(d):
    p = d["particles"]
    return p["mass"][p["alive"]].sum() + d["sinks"]["mass"].sum()


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax_shard_map(ranks, name):
    """make_sharded_prime, then make_sharded_step (one PM step, fixed h),
    or sharded_run_until (variable h, a fat sink, TreePM, the Kahan carry)
    on 4 gloo ranks against JAX's slab run under shard_map, per pid:
    rho, u, h and P within rtol 5e-6 after the step, vel within rtol 2e-4
    and atol 1e-5, dt, and all seven stats slots; after the variable-h run
    h within 1e-5, u within 1e-5, the sinks' mass within 1e-6, the same
    particles accreted (some, across ranks) and the mass conserved."""
    theirs = _jax_run(name)
    ours = ranks[4][0][name]
    a, b = _by_pid(ours), _by_pid(theirs)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    np.testing.assert_allclose(float(ours["dt"]), float(theirs["dt"]),
                               rtol=1e-6)
    if name == "pm_step":
        np.testing.assert_array_equal(ours["stats"], theirs["stats"])
        assert ours["stats"][6] == 0   # decomp_pressure
        for f in ("rho", "u", "h", "pressure"):
            np.testing.assert_allclose(a[f], b[f], rtol=FIELD_RTOL,
                                       atol=1e-12, err_msg=f)
        np.testing.assert_allclose(a["vel"], b["vel"], **VEL_TOL)
        return
    assert float(ours["t"]) >= T_STOP
    start = ranks["states"][name]
    assert len(a["pid"]) < int(start["particles"]["alive"].sum())
    np.testing.assert_allclose(a["h"], b["h"], rtol=H_RTOL)
    np.testing.assert_allclose(a["u"], b["u"], rtol=U_RTOL)
    np.testing.assert_allclose(ours["sinks"]["mass"], theirs["sinks"]["mass"],
                               rtol=SINK_RTOL)
    np.testing.assert_allclose(_mass(ours), _mass(start), rtol=1e-12)
    assert ours["particles"]["u_c"] is not None


def _one_device(name, state):
    """The port's single-device prime + step (pm_step) or run_steps(3)
    (var_h) from the padded state of a case."""
    cfg = SimConfig(**CASES[name][0])
    st = init_carries(tstate.from_numpy(state, device="cpu"), cfg)
    if name == "pm_step":
        return tstate.to_numpy(step(prime(st, cfg), cfg))
    return tstate.to_numpy(run_steps(st, cfg, 3))


@pytest.mark.parametrize("world,name", [(4, "pm_step"), (4, "var_h"),
                                        (2, "var_h")])
def test_ranks_match_the_port_on_one_device(ranks, world, name):
    """The slab runs (4 ranks: prime + step, sharded_run_until of one
    segment of 3 steps; 2 ranks: make_sharded_run_steps(3))
    against the port's single-device run from the same padded state, per
    pid, within rtol 1e-9 on every live field, acc included (float64:
    the slab's columns sum in another order), the same stats but
    decomp_pressure, which is 0."""
    ours = ranks[world][0][name]
    ref = _one_device(name, ranks["states"][name])
    a, b = _by_pid(ours), _by_pid(ref)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    for f in ("pos", "vel", "acc", "u", "rho", "h", "pressure", "du",
              "dalpha", "alpha"):
        np.testing.assert_allclose(a[f], b[f], rtol=1e-9, atol=1e-14,
                                   err_msg=f)
    np.testing.assert_allclose(ours["sinks"]["mass"], ref["sinks"]["mass"],
                               rtol=1e-12)
    assert float(ours["t"]) == pytest.approx(float(ref["t"]), rel=1e-12)
    np.testing.assert_array_equal(ours["stats"], ref["stats"])


def test_communication_stays_rim_sized(ranks):
    """test_decomp_comm_scales_with_rim_not_n (:280-312) by the port's
    byte counts: one slab step's all-gathers move under 1/10 of gather
    mode's at the same N, and its all-gather, shift, all-to-all and
    reduction bytes stay the same as N per rank doubles (256 -> 512 rows)
    at a fixed rim."""
    slab1, slab2, gath = (ranks[4][0][k] for k in
                          ("bytes_slab_1024", "bytes_slab_2048",
                           "bytes_gather_2048"))
    assert gath["all_gather"] > 0 and slab2["ppermute"] > 0
    assert slab2["all_gather"] < gath["all_gather"] / 10, (slab2, gath)
    assert slab1 == slab2, (slab1, slab2)


# ------------------------------------------------------ the pencil solve

@pytest.mark.parametrize("world,name", [(4, "pencil"), (2, "pencil"),
                                        (4, "pencil_fallback")])
def test_pencil_matches_replicated_solve(ranks, world, name):
    """pm_long_range with decomp on 2 and 4 ranks (grid 16: the pencil
    solve, its transforms split over the ranks; grid 18 on 4 ranks: the
    summed mesh and the replicated solve, as in the JAX package) against
    the replicated solve of the whole set on one device, within 5e-6 x
    max|acc| (test_decomp.py:361-395)."""
    pencil, kw = ranks["pencil"]
    got = ranks[world]
    cfg = SimConfig(**kw)
    if name == "pencil_fallback":
        cfg = cfg.with_(grav_grid=18)
    p = Particles(**{k: torch.from_numpy(v) for k, v in pencil.items()})
    ref = pm_gravity.pm_long_range(p, cfg)[0].numpy()
    acc = np.concatenate([r[name]["acc"] for r in got])
    np.testing.assert_allclose(acc, ref, rtol=0,
                               atol=5e-6 * np.abs(ref).max())
    assert all(r[name]["pencil"] == (name == "pencil") for r in got)


# ------------------------------------------------------- key_rows passes

def _slab_states(device, n, dtype=torch.float64):
    """A disc with fixed h and one with variable h (h from 0.6 to 1.8 x
    h0, by radius), sorted, with the density fields of a density pass."""
    from summersph_tpu_torch.models.disc import disc_ic

    out = {}
    for fixed_h in (2.5, None):
        cfg = SimConfig(fixed_h=fixed_h, neighbor_mode="sorted",
                        sorted_block=128, window_group=32,
                        dtype="float64" if dtype == torch.float64
                        else "float32")
        st, _ = disc_ic(n=n, r_max=40.0, seed=2, cfg=cfg, h0=2.5,
                        device=device)
        p = st.particles
        if fixed_h is None:
            r = torch.linalg.norm(p.pos, dim=1)
            p = p.replace(h=2.5 * (0.6 + 1.2 * r / torch.amax(r)))
        p2, grid = sort_particles(p, cfg)
        pd = cuda_pairs.pair_eval(p2, cfg, grid)[0]
        out["fixed" if fixed_h else "var"] = (pd, grid, cfg)
    return out


def _key_rows_cases(states, slabs=4):
    """(name, slab index, columns, local grid, rows, row keys, cfg,
    whole-set rows) of the four key_rows forms on `slabs` in-process
    slabs, with the smallest power-of-two rim from 512 rows up that
    leaves no row short."""
    cases = []
    for h in ("fixed", "var"):
        pd, grid, cfg = states[h]
        nl = pd.capacity // slabs
        whole_d = cuda_pairs.density_sums(pd, cfg, grid)
        whole_f = cuda_pairs.force_sums(pd, cfg, grid)
        halo = 512
        while True:
            local = slabs_in_process(pd, grid, cfg, slabs, halo)
            if not any(int(sl[4]) for sl in local) or halo >= pd.capacity:
                break
            halo *= 2
        for d, (key, own, cols, lgrid, short) in enumerate(local):
            assert int(short) == 0
            sl = slice(d * nl, (d + 1) * nl)
            cases.append((f"density {h} h", d, cols, lgrid, own, key, cfg,
                          [w[sl] for w in whole_d]))
            cases.append((f"force {h} h", d, cols, lgrid, own, key, cfg,
                          [w[sl] for w in whole_f]))
    return cases


def _call(name, cols, lgrid, own, key, cfg, plain=False):
    if name.startswith("density"):
        fn = cuda_pairs.density_sums_plain if plain else cuda_pairs.density_sums
    else:
        fn = cuda_pairs.force_sums_plain if plain else cuda_pairs.force_sums
    return fn(cols, cfg, lgrid, rows=(own, key))


def test_plain_key_rows_passes_equal_the_whole_set():
    """The plain versions' key_rows form: each of 4 slabs of a sorted
    2048-particle disc, summed against its [left rim | own | right rim]
    columns (`slabs_in_process`, rims wide enough that no row is short:
    512 rows),
    equals the whole-set sums of its rows in float64 (the columns sum in
    another order) for the density and force passes with fixed and
    variable h; the row set's own h is read (not the columns')."""
    cases = _key_rows_cases(_slab_states("cpu", 2048))
    for name, d, cols, lgrid, own, key, cfg, whole in cases:
        got = _call(name, cols, lgrid, own, key, cfg)
        for c, (a, b) in enumerate(zip(got, whole)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(b.abs().max()),
                                       err_msg=f"{name} slab {d} out {c}")
    name, d, cols, lgrid, own, key, cfg, _ = cases[2]   # density, var h
    bigger = own.replace(h=own.h * 1.1)
    moved = cuda_pairs.density_sums(cols, cfg, lgrid, rows=(bigger, key))
    assert not torch.equal(moved[0], _call(name, cols, lgrid, own, key,
                                           cfg)[0])


def test_key_rows_launch_checks():
    """A key_rows launch refuses a gate and row keys that do not match
    its rows."""
    name, d, cols, lgrid, own, key, cfg, _ = _key_rows_cases(
        _slab_states("cpu", 1024))[0]
    with pytest.raises(ValueError):
        cuda_pairs.density_sums(cols, cfg, lgrid, rows=(own, key[:-32]))
    work = (torch.zeros(lgrid.starts.shape[0], dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_pairs.density_sums(cols, cfg, lgrid, active=work,
                                rows=(own, key))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_key_rows_kernels(cuda_device):
    """The four key_rows instantiations (density_fixed_h_rows,
    density_var_h_rows, force_fixed_h_rows, force_var_h_rows launched
    with a separate row set) on 4 slabs of a 131,072-particle disc:
    each within the plain version's tolerances of its plain version and,
    per row, of the whole-set launch; one launch each a slab, counted in
    the key_rows counters."""
    def counted():
        return sum(getattr(w, a) for w, a in cuda_pairs.launch_counters()
                   if "key_rows_" in a)

    before = counted()
    cases = _key_rows_cases(_slab_states(cuda_device, 131072,
                                         torch.float32))
    for name, d, cols, lgrid, own, key, cfg, whole in cases:
        got = _call(name, cols, lgrid, own, key, cfg)
        plain = _call(name, cols, lgrid, own, key, cfg, plain=True)
        torch.cuda.synchronize()
        rtol = 2e-5 if name.startswith("density") else 2e-4
        for c, (a, b, w) in enumerate(zip(got, plain, whole)):
            atol = 1e-5 * float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                       msg=f"{name} slab {d} out {c}")
            torch.testing.assert_close(a, w, rtol=rtol, atol=atol,
                                       msg=f"{name} slab {d} out {c}")
    assert counted() - before == len(cases)
