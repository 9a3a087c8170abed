"""The port's spans and counters (`summersph_tpu_torch.tracing`) on the
CPU: nothing recorded without a profiler, the span tree of a 2-step disc
run, of a 2-step config 5 run, of a block step, of `prime` and a step
with direct gravity, and of `prime` and a step on a mesh of two gloo
ranks in gather mode and in the slab decomposition, under a CPU
`torch.profiler`; the clock (the profiler's `aten::sort` inside the
`sort` span on the trace's axis), the sort's counters against their
arithmetic, and a profiled run's state equal bit for bit to an
unprofiled one.  No JAX: the spawned ranks import this module."""

import dataclasses
import os
import pickle
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile

from summersph_tpu_torch import tracing
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import init_carries, prime, run_steps
from summersph_tpu_torch.models.disc import disc_ic
from summersph_tpu_torch.ops.sorted_grid import sort_h_pad, sort_particles
from summersph_tpu_torch.parallel import (make_mesh, pad_state_to_devices,
                                          shard_state)
from summersph_tpu_torch.tools import config5

N = 1024
H0 = 100.0 * (60.0 / N) ** (1.0 / 3.0) / 2.0   # bench.py's h0 formula


def disc():
    cfg = SimConfig(fixed_h=H0, gravity="none", neighbor_mode="sorted",
                    sorted_block=128, window_group=64, gamma=1.4,
                    bounding_size=1500.0, dt_init=1e-4, dt_min=1e-5,
                    dt_max=1e-3)
    state = disc_ic(n=N, r_max=100.0, m_star=5.0, h0=H0,
                    rotation="keplerian", cfg=cfg, seed=0, device="cpu")[0]
    return prime(state, cfg), cfg


def collapse():
    """Config 5's smoke build at N, with the full run's pm_every 4, so that
    a step holds the far field."""
    state, cfg = config5.build(N, smoke=True, device="cpu")
    cfg = cfg.with_(pm_every=4)
    return prime(state, cfg), cfg


def profiled(fn):
    """fn() under a CPU torch.profiler: (its result, the profiler,
    tracing.collect())."""
    tracing.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, tracing.collect()


def tree(spans, parent=-1):
    """The spans under `parent` as nested (name, step, children) tuples,
    in the order they opened."""
    return [(s[0], s[2], tree(spans, i)) for i, s in enumerate(spans)
            if s[1] == parent]


def leaves(*names):
    return [(n, None, []) for n in names]


def with_step(nodes, k):
    return [(n, k, with_step(c, k)) for n, _, c in nodes]


def disc_step(k):
    return ("step", k, with_step(
        leaves("kick", "drift")
        + [("force_eval", None,
            leaves("sort", "density", "eos", "force", "sink_gravity"))]
        + leaves("kick", "timestep", "accrete", "cull", "stats"), k))


PM_CHILDREN = ("pm_deposit", "pm_poisson", "pm_gradient", "pm_gather")


def collapse_step(k, solve):
    solve_span = ("pm_long_range", None, leaves(*PM_CHILDREN))
    gravity = (([solve_span] if solve else [])
               + [("grav_short", None, leaves("grav_sort"))])
    return ("step", k, with_step(
        leaves("kick", "drift")
        + [("force_eval", None,
            leaves("sort", "density", "eos", "force") + gravity
            + leaves("sink_gravity"))]
        + leaves("kick", "timestep")
        + [("h_iter", None, leaves("density", "density"))]
        + leaves("create_sinks", "accrete", "merge_sinks", "cull",
                 "stats"), k))


def test_no_profiler_records_nothing():
    state, cfg = disc()
    tracing.collect()
    run_steps(state, cfg, 2)
    got = tracing.collect()
    assert got == {"spans": [], "counters": {}, "dropped": 0}
    assert tracing.span("sort") is tracing.span("step")   # one null context


@pytest.mark.parametrize("case", ["disc", "collapse"])
def test_span_tree_of_a_two_step_run(case):
    state, cfg = disc() if case == "disc" else collapse()
    _, _, got = profiled(lambda: run_steps(state, cfg, 2))
    spans = got["spans"]
    assert got["dropped"] == 0
    assert all(t1 >= t0 > 0 for *_, t0, t1 in spans)
    assert all(spans[p][3] <= t0 and t1 <= spans[p][4]
               for _, p, _, t0, t1 in spans if p >= 0)
    if case == "disc":
        steps = [disc_step(0), disc_step(1)]
    else:   # a step solves the mesh at phase 0 of cfg.pm_every
        steps = [collapse_step(k, k % cfg.pm_every == 0) for k in (0, 1)]
    want = [("segment", -1, [steps[0], ("stats", 0, []),
                             steps[1], ("stats", 1, [])])]
    assert tree(spans) == want


def test_span_tree_of_a_block_step():
    state, cfg = disc()
    cfg = cfg.with_(dt_bins=2)
    _, _, got = profiled(lambda: run_steps(state, cfg, 1))
    substep = ("substep", None,
               leaves("kick", "drift", "sort", "density", "eos", "force",
                      "sink_gravity", "kick", "accrete", "cull", "stats"))
    step = ("step", 0, with_step(
        leaves("timestep") + [substep, substep] + leaves("timestep"), 0))
    assert tree(got["spans"]) == [("segment", -1, [step, ("stats", 0, [])])]


def test_sort_span_holds_the_profilers_sort_on_its_axis():
    state, cfg = disc()
    _, prof, got = profiled(lambda: run_steps(state, cfg, 1))
    start = prof.profiler.kineto_results.trace_start_ns()
    (sort_span,) = [s for s in got["spans"] if s[0] == "sort"]
    a, b = ((sort_span[3] - start) * 1e-3, (sort_span[4] - start) * 1e-3)
    sorts = [e for e in prof.events() if e.name == "aten::sort"]
    assert sorts
    assert all(a <= e.time_range.start <= e.time_range.end <= b
               for e in sorts)


@pytest.mark.parametrize("case", ["disc", "collapse"])
def test_sort_counters_equal_the_window_arithmetic(case):
    state, cfg = disc() if case == "disc" else collapse()
    p = state.particles
    (_, grid), _, got = profiled(
        lambda: sort_particles(p, cfg, h_pad=sort_h_pad(cfg)))
    ext = int(torch.sum((grid.ends - grid.starts).to(torch.int64)))
    assert got["counters"] == {"sph_candidates": ext * cfg.window_group,
                               "sph_rows": int(p.n_alive)}


def test_profiled_state_is_bitwise_the_unprofiled_state():
    state, cfg = collapse()
    plain = run_steps(state, cfg, 2)
    traced, _, got = profiled(lambda: run_steps(state, cfg, 2))
    assert set(got["counters"]) == {"sph_candidates", "sph_rows",
                                    "grav_candidates", "grav_rows",
                                    "sink_live_slots"}

    def fields(st):
        out = {"t": st.t, "dt": st.dt, "stats": st.stats,
               "pm_r_s": st.pm_r_s}
        for part in ("particles", "sinks"):
            tree_ = getattr(st, part)
            for f in dataclasses.fields(tree_):
                out[f"{part}.{f.name}"] = getattr(tree_, f.name)
        return out

    a, b = fields(plain), fields(traced)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert torch.equal(a[k], b[k]), k


SINK_SPANS = ("sink_gravity", "create_sinks", "accrete", "merge_sinks")


@pytest.mark.parametrize("case", ["disc", "collapse"])
def test_sink_live_slots_sums_the_live_slots_of_each_sink_pass(case):
    """sink_live_slots: the live slots each sink call saw, summed over the
    span tree's sink spans (config 5: its one massless dummy slot of 128,
    four calls a step; the disc: its star, two calls a step)."""
    state, cfg = disc() if case == "disc" else collapse()
    out, _, got = profiled(lambda: run_steps(state, cfg, 2))
    live = int(state.sinks.n_alive)
    assert live == int(out.sinks.n_alive) == 1
    calls = sum(s[0] in SINK_SPANS for s in got["spans"])
    assert calls == 2 * (4 if case == "collapse" else 2)
    assert got["counters"]["sink_live_slots"] == calls * live


def test_buffer_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    tracing.collect()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with tracing.span("step"):
                pass
    got = tracing.collect()
    assert [(s[0], s[2]) for s in got["spans"]] == [("step", 0),
                                                    ("step", 1),
                                                    ("step", 2)]
    assert got["dropped"] == 2


# ------------------------------------------- prime, direct gravity, mesh

def small_disc(**over):
    """A 256-particle disc with a sink, as tests/test_torch_decomp.py's
    slab runs build it, and its config."""
    cfg = SimConfig(**{**dict(
        fixed_h=20.0, gravity="none", neighbor_mode="sorted",
        decomp="slab", halo_rows=128, migrate_rows=128, halo_hops=3,
        sorted_block=128, window_group=32, gamma=1.4, bounding_size=1500.0,
        sink_capacity=4, dt_init=1e-4), **over})
    state = disc_ic(n=256, r_max=50.0, m_star=1.0, h0=20.0,
                    rotation="keplerian", capacity=256, sink_capacity=4,
                    cfg=cfg, seed=3, device="cpu")[0]
    return init_carries(state, cfg), cfg


def prime_and_step(state, cfg, mesh=None):
    """The span tree of `prime` then a 1-step `run_steps`, profiled."""
    _, _, got = profiled(lambda: run_steps(prime(state, cfg, mesh), cfg, 1,
                                           axis_name=mesh))
    assert got["dropped"] == 0
    return tree(got["spans"])


def primed_step(pair_pass):
    """`prime` (its force pass at step -1) and one step whose force pass
    is `pair_pass`."""
    step = ("step", 0, with_step(
        leaves("kick", "drift") + [("force_eval", None, pair_pass)]
        + leaves("kick", "timestep", "accrete", "cull", "stats"), 0))
    return [("prime", -1, [("force_eval", -1, with_step(pair_pass, -1))]),
            ("segment", -1, [step, ("stats", 0, [])])]


def test_span_tree_of_prime_and_direct_gravity():
    state, cfg = small_disc(gravity="direct", decomp="gather")
    assert prime_and_step(state, cfg) == primed_step(leaves(
        "sort", "density", "eos", "force", "gravity_direct",
        "sink_gravity"))


MESH_PASSES = {
    "gather": leaves("gather", "sort", "density", "eos", "gather", "force",
                     "sink_gravity"),
    "slab": leaves("redistribute", "exchange_rim", "density", "eos",
                   "exchange_rim", "force", "sink_gravity"),
}


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(world, device="cpu")
        trees = {}
        for decomp in MESH_PASSES:
            state, cfg = small_disc(decomp=decomp)
            state = shard_state(pad_state_to_devices(state, world), mesh)
            trees[decomp] = prime_and_step(state, cfg, mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(trees, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_trees(tmp_path_factory):
    """[rank] -> {decomp: span tree} of two gloo ranks."""
    tmp = tmp_path_factory.mktemp("tracing_mesh")
    mp.spawn(_rank_main, args=(2, str(tmp / "rendezvous"), str(tmp)),
             nprocs=2, join=True)
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("decomp", list(MESH_PASSES))
def test_span_tree_on_a_mesh(mesh_trees, decomp):
    want = primed_step(MESH_PASSES[decomp])
    assert [trees[decomp] for trees in mesh_trees] == [want, want]
