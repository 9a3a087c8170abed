"""The force and gravity pair passes of `ops/cuda_pairs.py` on window
shapes that are hard for a kernel (`models/ragged.py`): empty ranges,
ranges of 1, 31, 32, 33 and 129 candidates, a last group that ends in dead
rows, rows with no pair inside their support, a group whose every
candidate is a pair, a tight clump, and an h gradient whose pairs reach
only from their j side.

On the CPU the plain versions (`force_sums_plain` with fixed h, variable h
and fused gravity; `grav_short_sums_plain`) are held against the JAX
package in float64: the XLA sorted engine (`sorted_density`,
`sorted_forces`) and `pm_short_range`, each on its own sort, compared per
pid at rtol 1e-10.  The pack that feeds the CUDA kernels (`pack_geometry`,
`pack_force`; on the CPU its plain version) is held here too.

The tests marked `gpu` hold the CUDA kernels against the plain versions on
the same cases on the card; they need no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_pairs_ragged.py
"""

import functools

import numpy as np
import pytest
import torch

from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.models import ragged
from summersph_tpu_torch.ops import cuda_pairs, pm_gravity
from summersph_tpu_torch.ops.sorted_grid import (SENTINEL_KEY,
                                                 group_worklist,
                                                 sort_particles)
from summersph_tpu_torch.state import Particles

WG = 32
FORMS = [(case, var) for case in ragged.CASES for var in (False, True)]
FORM_IDS = [f"{case}-{'var_h' if var else 'fixed_h'}" for case, var in FORMS]
SPH_FIELDS = ("rho", "omega", "acc", "du", "dalpha")


def _kw(case, var, dtype="float64"):
    return dict(fixed_h=None if var else case["h0"], neighbor_mode="sorted",
                sorted_block=128, window_group=WG, window_blocks=5,
                grav_window_blocks=12, gravity="pm", use_pallas=False,
                dtype=dtype)


def _particles(case, var, dtype, device):
    return Particles.create(
        pos=case["pos"], vel=case["vel"], mass=case["mass"], u=case["u"],
        h=case["h"] if var else case["h0"], capacity=case["capacity"],
        dtype=dtype, device=device)


def _split(case, cfg, dtype, device):
    """(r_s, r_cut) with r_cut the case's cutoff, no wider than the cell."""
    r_cut = torch.tensor(case["r_cut"], dtype=dtype, device=device)
    return r_cut / cfg.effective_rcut_rs(), r_cut


def _sorted_state(name, var, dtype=torch.float32, device="cpu"):
    """(case, sorted particles carrying rho, P, omega and cs, grid, cfg,
    split) of one ragged case."""
    case = ragged.ragged_case(name)
    cfg = SimConfig(**_kw(case, var, str(dtype).split(".")[1]))
    p2, grid = sort_particles(_particles(case, var, dtype, device), cfg)
    p3 = cuda_pairs.pair_eval(p2, cfg, grid)[0]
    return case, p3, grid, cfg, _split(case, cfg, dtype, device)


def _by_pid(pid, n, **arrays):
    order = np.argsort(np.asarray(pid))[:n]
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


@functools.lru_cache(maxsize=None)
def _jax_reference(name, var):
    """The JAX package on one case in float64, per pid over the live
    particles: density, EOS and forces of the XLA sorted engine, and the
    short-range gravity of `pm_short_range` at the case's cutoff."""
    import jax.numpy as jnp
    from summersph_tpu.config import SimConfig as JaxConfig
    from summersph_tpu.ops import pm_gravity as jpm
    from summersph_tpu.ops.eos import eos_update
    from summersph_tpu.ops.sorted_grid import sort_particles as jax_sort
    from summersph_tpu.ops.sorted_grid import sorted_density, sorted_forces
    from summersph_tpu.state import Particles as JParticles

    case = ragged.ragged_case(name)
    n = case["pos"].shape[0]
    jcfg = JaxConfig(**_kw(case, var))
    jp = JParticles.create(
        pos=case["pos"], vel=case["vel"], mass=case["mass"], u=case["u"],
        h=case["h"] if var else case["h0"], capacity=case["capacity"],
        dtype=jnp.float64)
    jp2, jgrid = jax_sort(jp, jcfg)
    assert int(jgrid.n_window_overflow) == 0
    jp3 = eos_update(sorted_density(jp2, jcfg, jgrid), jcfg)
    acc, du, dal = sorted_forces(jp3, jcfg, jgrid)
    out = _by_pid(jp3.pid, n, rho=jp3.rho, omega=jp3.omega, acc=acc, du=du,
                  dalpha=dal)
    r_s = case["r_cut"] / jcfg.effective_rcut_rs()
    g, over = jpm.pm_short_range(jp, jcfg, jnp.asarray(r_s, jnp.float64))
    assert int(over) == 0
    out["acc_grav"] = np.asarray(g)[:n]
    return out


def _close(ours, theirs, name):
    np.testing.assert_allclose(ours, theirs, rtol=1e-10,
                               atol=1e-13 * np.abs(theirs).max(),
                               err_msg=name)


# ------------------------------------------------- the shapes themselves

def test_cluster_case_has_the_hard_window_shapes():
    case, p3, grid, cfg, split = _sorted_state("clusters", False,
                                               torch.float64)
    lengths = ragged.range_lengths(grid)
    assert {0, 1, 31, 32, 33, 129} <= lengths
    n = case["pos"].shape[0]
    assert n % WG and case["capacity"] > n          # a group ends in dead rows
    last = n // WG
    assert bool(p3.alive[last * WG]) and not bool(p3.alive[(last + 1) * WG - 1])
    assert int(grid.key[-1]) == SENTINEL_KEY
    assert not (grid.ends - grid.starts)[last + 1:].any()     # all-dead groups
    # per row, over its group's ranges under its key mask: pairs inside 2h
    pairs, cands = [], []
    for rows, idx, valid, off in cuda_pairs._candidate_chunks(grid, WG):
        mask, _, _, _, r2 = cuda_pairs._pair_geometry(p3.pos, grid, rows,
                                                      idx, valid, off)
        inside = mask & (r2 > 0.0) & (r2 < 4.0 * case["h0"] ** 2)
        pairs.append(inside.sum(-1).flatten())
        cands.append(valid.sum(-1)[:, None].expand(rows.shape).flatten())
    pairs, cands = torch.cat(pairs)[:n], torch.cat(cands)[:n]
    # rows with candidates but no pair (singles; the two far corners), and
    # a whole group whose every candidate but the row itself is a pair
    assert int(((pairs == 0) & (cands > 0)).sum()) >= 4
    tight = sum(ragged.CLUSTER_SIZES[:ragged.TIGHT_CLUSTER])
    assert tight % WG == 0
    assert bool((pairs[tight:tight + WG] == WG - 1).all())
    assert bool((cands[tight:tight + WG] == WG).all())


def test_h_gradient_case_has_pairs_that_reach_only_from_j():
    case = ragged.ragged_case("h_gradient")
    pos, h = torch.tensor(case["pos"]), torch.tensor(case["h"])
    r = torch.cdist(pos, pos)
    j_only = (r >= 2.0 * h[:, None]) & (r < 2.0 * h[None, :])
    assert int(j_only.sum()) > 1000
    assert float(h.max() / h.min()) > 3.0


def test_clump_case_needs_more_than_one_chunk_of_candidates():
    """One group of the clump has more candidates than the force kernel
    stages at a time (1024), most of them pairs."""
    _, _, grid, _, _ = _sorted_state("clump", False)
    assert int((grid.ends - grid.starts).sum(dim=1).max()) > 1024


# --------------------------------------- the plain versions against JAX

@pytest.mark.parametrize("name,var", FORMS, ids=FORM_IDS)
def test_plain_force_sums_match_jax_sorted_engine_f64(name, var):
    case, p3, grid, cfg, _ = _sorted_state(name, var, torch.float64)
    n = case["pos"].shape[0]
    out = cuda_pairs.pair_eval(p3, cfg, grid)
    ours = _by_pid(out[0].pid, n, rho=out[0].rho, omega=out[0].omega,
                   acc=out[1], du=out[2], dalpha=out[3])
    theirs = _jax_reference(name, var)
    assert np.abs(ours["acc"]).max() > 0.0
    for field in SPH_FIELDS:
        _close(ours[field], theirs[field], field)


@pytest.mark.parametrize("name,var", FORMS, ids=FORM_IDS)
def test_plain_fused_force_sums_match_jax_f64(name, var):
    """The fused form: its five SPH sums are the unfused ones bit for bit,
    and its gravity sums over the SPH windows equal `pm_short_range` of the
    JAX package at the same cutoff (r_cut fits the sorted cell)."""
    case, p3, grid, cfg, split = _sorted_state(name, var, torch.float64)
    assert float(split[1]) <= float(grid.cell_size)
    fused = cuda_pairs.force_sums_plain(p3, cfg, grid, split)
    for a, b in zip(fused[:5], cuda_pairs.force_sums_plain(p3, cfg, grid)):
        assert torch.equal(a, b)
    n = case["pos"].shape[0]
    out = cuda_pairs.pair_eval(p3, cfg, grid, split)
    ours = _by_pid(out[0].pid, n, acc_grav=out[4])["acc_grav"]
    theirs = _jax_reference(name, var)["acc_grav"]
    assert np.abs(theirs).max() > 0.0
    _close(ours, theirs, "acc_grav")


@pytest.mark.parametrize("name,var", FORMS, ids=FORM_IDS)
def test_plain_grav_short_sums_match_jax_pm_short_range_f64(name, var):
    """`grav_short_sums_plain` through the port's own gravity sort."""
    case = ragged.ragged_case(name)
    cfg = SimConfig(**_kw(case, var))
    p = _particles(case, var, torch.float64, "cpu")
    r_s, _ = _split(case, cfg, torch.float64, "cpu")
    acc, over = pm_gravity.pm_short_range(p, cfg, r_s)
    assert int(over) == 0
    n = case["pos"].shape[0]
    assert not acc[n:].any()
    _close(acc.numpy()[:n], _jax_reference(name, var)["acc_grav"],
           "acc_short")


@pytest.mark.parametrize("name,var", FORMS, ids=FORM_IDS)
def test_gated_plain_sums_equal_the_ungated_on_ragged_windows(name, var):
    _, p3, grid, cfg, split = _sorted_state(name, var)
    act = p3.alive & (p3.pos[:, 0] < p3.pos[p3.alive, 0].median())
    gate = group_worklist(act, WG)
    listed = torch.zeros(p3.capacity // WG, dtype=torch.bool)
    listed[gate[0][:int(gate[1])].long()] = True
    rows = listed.repeat_interleave(WG)
    m = torch.where(p3.alive, p3.mass, 0.0)
    for active in (None, gate):
        sums = _flat(cuda_pairs.force_sums_plain(p3, cfg, grid, split,
                                                 active))
        sums += cuda_pairs.grav_short_sums_plain(p3.pos, m, p3.h, grid, cfg,
                                                 split, active)
        if active is None:
            ungated = sums
    for a, b in zip(ungated, sums):
        assert torch.equal(a[rows], b[rows]) and not b[~rows].any()


def _flat(out):
    return [t for o in out for t in (o if isinstance(o, tuple) else (o,))]


# ----------------------------------------------------- the wrapper's pack

def test_pack_geometry_keeps_every_key_bit_for_bit():
    """Any int32 survives as the fourth word of the 16-byte record: the
    sentinel of dead rows, negative keys, and the patterns that read as a
    NaN or an infinity when taken for a float."""
    rng = np.random.default_rng(0)
    special = np.array([SENTINEL_KEY, 0, -1, 1, np.iinfo(np.int32).min,
                        np.iinfo(np.int32).max, 0x7FC00001, 0x7F800001,
                        0x7F800000, -0x00800000, -0x007FFFFF], np.int64)
    key = np.concatenate([special, rng.integers(-2**31, 2**31, 245)])
    key = torch.from_numpy(key.astype(np.int32))
    pos = torch.from_numpy(rng.standard_normal((256, 3)).astype(np.float32))
    pos[3] = torch.tensor([float("nan"), float("inf"), -0.0])
    geo = cuda_pairs.pack_geometry(pos, key)
    assert geo.dtype == torch.int32 and geo.shape == (256, 4)
    assert geo.is_contiguous()
    assert torch.equal(geo[:, 3], key)
    assert torch.equal(geo[:, :3], pos.view(torch.int32))
    # a strided view of the positions packs the same bits
    wide = torch.zeros(256, 5)
    wide[:, 1:4] = pos
    assert torch.equal(cuda_pairs.pack_geometry(wide[:, 1:4], key), geo)


@pytest.mark.parametrize("var", [False, True], ids=["fixed_h", "var_h"])
def test_pack_force_records(var):
    _, p3, grid, cfg, _ = _sorted_state("clusters", var)
    assert not bool(p3.alive.all())
    # a live row whose density underflows: the guard, not a division by 0
    p3 = p3.replace(rho=p3.rho.clone().index_fill_(
        0, torch.tensor([0]), 1e-20))
    geo, attr, sup2 = cuda_pairs.pack_force(p3, grid.key, var)
    assert torch.equal(geo, cuda_pairs.pack_geometry(p3.pos, grid.key))
    # one record a particle, in one 32-byte sector (two with variable h)
    assert attr.shape == (p3.capacity, 16 if var else 8)
    assert attr.is_contiguous() and attr.dtype == torch.float32
    assert torch.equal(attr[:, :3], p3.vel)
    assert torch.equal(attr[:, 3], torch.where(p3.alive, p3.mass, 0.0))
    assert not attr[~p3.alive, 3].any()
    assert bool((attr[p3.alive, 3] > 0).all())
    pterm = p3.pressure / torch.clamp(p3.omega * p3.rho * p3.rho,
                                      min=1.0e-30)
    assert torch.equal(attr[:, 4], pterm)
    assert bool(torch.isfinite(attr[:, 4]).all())
    assert float(attr[0, 4]) == float(p3.pressure[0] / 1.0e-30)
    for c, field in enumerate((p3.rho, p3.cs, p3.alpha), start=5):
        assert torch.equal(attr[:, c], field)
    if not var:
        assert sup2 is None
        return
    inv_h = 1.0 / p3.h
    assert sup2.is_contiguous()
    assert torch.equal(attr[:, 8], p3.h) and torch.equal(attr[:, 9], inv_h)
    assert torch.equal(attr[:, 10], ((1.0 / np.pi) * inv_h * inv_h)
                       * (inv_h * inv_h))
    assert torch.equal(attr[:, 11], 4.0 * p3.h * p3.h)
    assert torch.equal(sup2, attr[:, 11]) and not attr[:, 12:].any()


def test_pack_builds_no_tensor_from_host_data_and_reads_nothing(monkeypatch):
    """The pack runs on every launch: a tensor made from host data is a
    host-to-device copy, and a value read on the host (`aten::item`) makes
    the host wait for the card."""
    from torch.profiler import ProfilerActivity, profile

    _, p3, grid, cfg, _ = _sorted_state("clump", True)

    def refuse(*args, **kwargs):
        raise AssertionError("the pack built a tensor from host data")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cuda_pairs.pack_geometry(p3.pos, grid.key)
        cuda_pairs.pack_force(p3, grid.key, True)
        cuda_pairs.pack_force(p3, grid.key, False)
    ops = {e.key for e in prof.key_averages()}
    assert "aten::cat" in ops
    assert not ops & {"aten::item", "aten::_local_scalar_dense"}


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold_f64(names, ours, plain, exact):
    """Sums whose terms cancel lose digits in float32 in the kernel and its
    plain version alike: hold the kernel against the plain version in
    float64 within rtol 2e-4 and atol 1e-5 x max|component| + twice the
    float32 plain version's own largest error."""
    for name, a, b, r in zip(names, ours, plain, exact):
        floor = float((b.double() - r).abs().max())
        torch.testing.assert_close(
            a.double(), r, rtol=2e-4,
            atol=1e-5 * float(r.abs().max()) + 2 * floor, msg=name)


def _f64(p):
    return p.map(lambda a: a.double() if a.is_floating_point() else a)


@pytest.mark.gpu
@pytest.mark.parametrize("name,var", FORMS, ids=FORM_IDS)
def test_cuda_force_kernels_on_ragged_windows(cuda_device, name, var):
    """`force_fixed_h` / `force_var_h` and their fused and gated forms on
    the card: against the plain version in float64, two launches equal bit
    for bit, the fused form's SPH sums equal to the unfused ones, a gated
    launch equal to the ungated one on the listed rows and 0 elsewhere."""
    _, p3, grid, cfg, split = _sorted_state(name, var, device=cuda_device)
    p64, split64 = _f64(p3), tuple(v.double() for v in split)
    act = p3.alive & (p3.pos[:, 0] < p3.pos[p3.alive, 0].median())
    gate = group_worklist(act, WG)
    listed = torch.zeros(p3.capacity // WG, dtype=torch.bool,
                         device=cuda_device)
    listed[gate[0][:int(gate[1])].long()] = True
    rows = listed.repeat_interleave(WG)
    names = ("ax", "ay", "az", "du", "araw", "gx", "gy", "gz")
    unfused = None
    for sp, sp64 in ((None, None), (split, split64)):
        ours = _flat(cuda_pairs.force_sums(p3, cfg, grid, sp))
        torch.cuda.synchronize()
        again = _flat(cuda_pairs.force_sums(p3, cfg, grid, sp))
        assert all(torch.equal(a, b) for a, b in zip(ours, again))
        _hold_f64(names, ours,
                  _flat(cuda_pairs.force_sums_plain(p3, cfg, grid, sp)),
                  _flat(cuda_pairs.force_sums_plain(p64, cfg, grid, sp64)))
        gated = _flat(cuda_pairs.force_sums(p3, cfg, grid, sp, gate))
        for a, b in zip(ours, gated):
            assert torch.equal(a[rows], b[rows]) and not b[~rows].any()
        if sp is None:
            unfused = ours
        else:
            assert all(torch.equal(a, b) for a, b in zip(ours[:5], unfused))


@pytest.mark.gpu
@pytest.mark.parametrize("var", [False, True], ids=["fixed_h", "var_h"])
def test_cuda_pack_equals_its_plain_version_bit_for_bit(cuda_device, var):
    _, p3, grid, cfg, _ = _sorted_state("clusters", var, device=cuda_device)
    n0 = cuda_pairs.pack_force.launches
    ours = cuda_pairs.pack_force(p3, grid.key, var)
    assert cuda_pairs.pack_force.launches == n0 + 1
    plain = cuda_pairs.pack_force_plain(p3, grid.key, var)
    for a, b in zip(ours, plain):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name,var", FORMS, ids=FORM_IDS)
def test_cuda_grav_short_kernel_on_ragged_windows(cuda_device, name, var):
    _, p3, grid, cfg, split = _sorted_state(name, var, device=cuda_device)
    m = torch.where(p3.alive, p3.mass, 0.0)
    args = (p3.pos, m, p3.h, grid, cfg, split)
    n0 = cuda_pairs.grav_short_sums.launches
    ours = cuda_pairs.grav_short_sums(*args)
    torch.cuda.synchronize()
    assert cuda_pairs.grav_short_sums.launches == n0 + 1
    assert all(torch.equal(a, b)
               for a, b in zip(ours, cuda_pairs.grav_short_sums(*args)))
    exact = cuda_pairs.grav_short_sums_plain(
        p3.pos.double(), m.double(), p3.h.double(), grid, cfg,
        tuple(v.double() for v in split))
    _hold_f64(("gx", "gy", "gz"), ours,
              cuda_pairs.grav_short_sums_plain(*args), exact)
    full = group_worklist(torch.ones_like(p3.alive), WG)
    for a, b in zip(ours, cuda_pairs.grav_short_sums(*args, full)):
        assert torch.equal(a, b)
