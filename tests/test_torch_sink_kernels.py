"""The sink layers' CUDA kernels (`ops/cuda_sinks.py`, `csrc/sinks.cu`)
against their plain versions (`sink_gravity_plain`, `create_sinks_plain`,
`accrete_plain`, `merge_sinks_plain`).

On the CPU the public functions take the plain versions: equal to them bit
for bit, with no sink kernel launch counted.  The tests marked `gpu` hold
each kernel against its plain version on the card and skip without one:
every mask, index and slot exactly, `alive` exactly, the float sums within
the tolerances of `hold` (a different summation order), in float32 and in
float64, and two launches bit for bit.  No JAX, so this file runs on a GPU
machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sink_kernels.py
"""

import numpy as np
import pytest
import torch

from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.ops import cuda_sinks, gravity, sinks
from summersph_tpu_torch.state import PARK_POSITION, Particles, Sinks

N_GPU = 5000 + 37   # a multiple of neither a block (256) nor a tile (1024)
N_CPU = 300
PATTERNS = ("all", "some", "dummy")
CFG = SimConfig(eta=1.2, sink_create_mass=1.0e-11, sink_merge_factor=1.0)


def gas(n, device, dtype, seed=0):
    """n particles in a cube of side 20, 10% of them dead (half of those
    parked, half left where they were), rows 0-3 live."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10.0, 10.0, (n, 3))
    dead = rng.random(n) < 0.1
    dead[:4] = False
    pos[dead & (rng.random(n) < 0.5)] = PARK_POSITION
    p = Particles.create(pos, rng.normal(0.0, 1.0, (n, 3)),
                         rng.uniform(0.5, 1.5, n) * 1e-3, u=1.0,
                         h=rng.uniform(0.2, 0.6, n), dtype=dtype,
                         device=device)
    return p.replace(alive=torch.as_tensor(~dead, device=device))


def slots(S, pattern, device, dtype, seed=1):
    """S sink slots: 'all' live and massive; 'some' with every third slot
    dead (half of those parked and massless, as Sinks.zeros leaves them,
    half not); 'dummy' only slot 0 live, massless, radius 0, at the origin,
    as config 5 starts.  With 'all' and S >= 2, slots 0 and 1 lie at (1, 3,
    -4) and (3, 3, -4)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-8.0, 8.0, (S, 3))
    mass = rng.uniform(1.0, 2.0, S)
    radius = rng.uniform(1.5, 3.0, S)
    alive = np.ones(S, dtype=bool)
    if pattern == "all" and S >= 2:
        pos[:2] = [[1.0, 3.0, -4.0], [3.0, 3.0, -4.0]]
    elif pattern == "some":
        alive = np.arange(S) % 3 != 1
        parked = ~alive & (np.arange(S) % 2 == 0)
        pos[parked], mass[parked], radius[parked] = PARK_POSITION, 0.0, 0.0
    elif pattern == "dummy":
        alive[:] = False
        alive[0] = True
        pos[~alive], mass[:], radius[:] = PARK_POSITION, 0.0, 0.0
        pos[0] = 0.0
    s = Sinks.create(pos, rng.normal(0.0, 1.0, (S, 3)), mass, radius,
                     capacity=S, dtype=dtype, device=device)
    return s.replace(
        spin=torch.as_tensor(rng.normal(0.0, 1e-3, (S, 3)), dtype=dtype,
                             device=device),
        acc=torch.as_tensor(rng.normal(0.0, 1.0, (S, 3)), dtype=dtype,
                            device=device),
        alive=torch.as_tensor(alive, device=device))


def place(p, s):
    """Row 0 exactly at slot 0 (r2 = 0) and, with two slots at (1, 3, -4)
    and (3, 3, -4), row 1 at equal distance 1 from both."""
    pos = p.pos.clone()
    pos[0] = s.pos[0]
    if s.capacity >= 2:
        pos[1] = torch.tensor([2.0, 3.0, -4.0], dtype=pos.dtype)
    return p.replace(pos=pos)


def threshold(p, cfg, q=0.95):
    """A creation threshold with 1 - q of the live gas above it."""
    cd = p.mass * (cfg.eta / p.h) ** 3
    return float(torch.quantile(cd[p.alive].double().cpu(), q))


def tie_densest(p, rows):
    """`rows` live, with twice the largest mass and the smallest h: their
    code densities tie above every other row's."""
    mass, h, alive = p.mass.clone(), p.h.clone(), p.alive.clone()
    mass[rows], h[rows], alive[rows] = 2.0 * p.mass.max(), p.h.min(), True
    return p.replace(mass=mass, h=h, alive=alive)


def counts():
    return [getattr(f, a) for f, a in cuda_sinks.launch_counters()]


def calls(cfg):
    """name -> (public function, plain version), each taking (p, s)."""
    return {
        "sink_gravity": (gravity.sink_gravity, gravity.sink_gravity_plain),
        "accrete": (sinks.accrete, sinks.accrete_plain),
        "create_sinks": (lambda p, s: sinks.create_sinks(p, s, cfg),
                         lambda p, s: sinks.create_sinks_plain(p, s, cfg)),
        "merge_sinks": (lambda p, s: sinks.merge_sinks(s, cfg),
                        lambda p, s: sinks.merge_sinks_plain(s, cfg)),
    }


def flat(out):
    """Every tensor of a result, in order, with its name."""
    got = []
    for k, x in enumerate(out):
        if isinstance(x, torch.Tensor):
            got.append((str(k), x))
        else:
            got += [(f"{k}.{name}", getattr(x, name))
                    for name in x.__dataclass_fields__
                    if getattr(x, name) is not None]
    return got


# ----------------------------------------------------------------- the CPU

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["sink_gravity", "accrete", "create_sinks",
                                  "merge_sinks"])
def test_public_function_is_its_plain_version_on_the_cpu(name, dtype):
    p = place(gas(N_CPU, "cpu", dtype), slots(8, "all", "cpu", dtype))
    s = slots(8, "all", "cpu", dtype)
    cfg = CFG.with_(sink_create_density=threshold(p, CFG))
    public, plain = calls(cfg)[name]
    before = counts()
    got, want = flat(public(p, s)), flat(plain(p, s))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert counts() == before == [0] * len(before)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def hold(name, kernel, plain, truth, dtype):
    """A float output of a kernel against the plain version.  float32: the
    kernel within 4x the plain version's own error against the float64
    plain version `truth`, or 2e-6 of the output's largest magnitude (both
    sum the same terms in another order; 2e-6 is ~16 float32 roundings of
    the largest term).  float64: within 1e-10 of the largest magnitude of
    the plain version (a different order of up to N float64 terms)."""
    kernel, plain = kernel.double(), plain.double()
    if dtype == torch.float64:
        scale = float(plain.abs().max()) if plain.numel() else 0.0
        err = float((kernel - plain).abs().max()) if plain.numel() else 0.0
        assert err <= 1e-10 * scale, f"{name}: {err:.3e} of {scale:.3e}"
        return
    truth = truth.double()
    if not truth.numel():
        return
    scale = float(truth.abs().max())
    err_k = float((kernel - truth).abs().max())
    err_p = float((plain - truth).abs().max())
    assert err_k <= 4.0 * err_p + 2e-6 * scale, (
        f"{name}: kernel {err_k:.3e}, plain {err_p:.3e}, scale {scale:.3e}")


def to64(tree):
    return tree.map(lambda t: t.double() if t.is_floating_point() else t)


def check(name, cfg, p, s, dtype, exact=()):
    """The kernel's result against the plain version's on the card (the
    fields named in `exact`, which the call copies or decides, and every
    integer and bool exactly, the others by `hold`), and two launches bit
    for bit; returns the plain result."""
    public, plain = calls(cfg)[name]
    k1, k2, want = public(p, s), public(p, s), plain(p, s)
    truth = plain(None if p is None else to64(p), to64(s))
    torch.cuda.synchronize()
    got, want_f, truth_f = flat(k1), flat(want), flat(truth)
    assert [k for k, _ in got] == [k for k, _ in want_f]
    for (k, a), (_, b) in zip(flat(k1), flat(k2)):
        assert torch.equal(a, b), f"{name} {k}: two launches differ"
    for (k, a), (_, b), (_, t) in zip(got, want_f, truth_f):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in exact or not a.is_floating_point():
            assert torch.equal(a, b), f"{name} {k}"
        else:
            hold(f"{name} {k}", a, b, t, dtype)
    return want


CASES = [(S, pattern, dtype) for S in (1, 8, 128) for pattern in PATTERNS
         for dtype in (torch.float32, torch.float64)]


def _ids(case):
    S, pattern, dtype = case
    return f"S{S}-{pattern}-{str(dtype)[6:]}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sink_gravity_kernel(cuda_device, case):
    S, pattern, dtype = case
    s = slots(S, pattern, cuda_device, dtype)
    p = place(gas(N_GPU, cuda_device, dtype), s)
    before = counts()
    check("sink_gravity", CFG, p, s, dtype)
    launched = [b - a for a, b in zip(before, counts())]
    assert launched[:2] == [2, 2] and not any(launched[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_accrete_kernel(cuda_device, case):
    """Copies and decisions exactly: which rows go, their parked and zeroed
    fields, every other row's fields, the sinks' unchanged fields; the
    sinks' sums by `hold`.  With 8 or 128 slots live, hundreds of rows go
    to several sinks in one call; row 0 sits on slot 0 (r2 = 0), and row 1
    at equal distance from slots 0 and 1 goes to slot 0."""
    S, pattern, dtype = case
    s = slots(S, pattern, cuda_device, dtype)
    p = place(gas(N_GPU, cuda_device, dtype), s)
    exact = ({f"0.{f}" for f in Particles.__dataclass_fields__}
             | {"1.alive", "1.radius", "1.acc"})
    want = check("accrete", CFG, p, s, dtype, exact=exact)
    gone = int(torch.sum(p.alive & ~want[0].alive))
    if pattern == "all":
        assert gone > (100 if S >= 8 else 1)
        assert not bool(want[0].alive[0])
        if S >= 2:
            assert not bool(want[0].alive[1])
    elif pattern == "dummy":
        assert gone == 0   # a massless sink accretes nothing


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_create_sinks_kernel(cuda_device, case):
    """The new sink's slot, position, velocity, radius and mass exactly,
    every other slot copied, `slots_full` exactly: 0 with a free slot, 1
    where every slot is live and a candidate stands.  Rows 2 and N - 3
    (in the first and the last block) tie at the largest code density: the
    first wins."""
    S, pattern, dtype = case
    s = slots(S, pattern, cuda_device, dtype)
    p = tie_densest(place(gas(N_GPU, cuda_device, dtype), s), [2, N_GPU - 3])
    cfg = CFG.with_(sink_create_density=threshold(p, CFG))
    every = {f"0.{f}" for f in Sinks.__dataclass_fields__}
    new_s, full = check("create_sinks", cfg, p, s, dtype, exact=every)
    free = not bool(s.alive.all())
    if free:
        assert int(full) == 0
        slot = int(torch.argmax((~s.alive).to(torch.int32)))
        assert bool(new_s.alive[slot])
        if pattern == "dummy":   # nothing vetoes the densest: row 2 wins
            assert torch.equal(new_s.pos[slot], p.pos[2])
    elif S <= 8:   # the slots cover too little to veto every candidate
        assert int(full) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_merge_sinks_kernel(cuda_device, case):
    S, pattern, dtype = case
    s = slots(S, pattern, cuda_device, dtype)
    check("merge_sinks", CFG, None, s, dtype,
          exact={"0.alive", "0.radius", "0.acc"})


# Eight sinks on a line one apart, radius 1.2 (factor 1: only neighbours
# pair), the slots along the line in the given order.  Each slot points at
# the lower of itself and its lower-index neighbour, so every local index
# minimum along the line is a root.  Descending: one chain of seven links
# that three rounds of jumps bring onto slot 0, which absorbs the other
# seven.  Shuffled: the local minima are slots 2, 3 and 0, so the line
# merges in three parts and five slots go.
CHAINS = {"descending": ([7, 6, 5, 4, 3, 2, 1, 0], [0]),
          "shuffled": ([2, 4, 3, 6, 5, 0, 1, 7], [0, 2, 3])}


def chain(order, device, dtype):
    S = len(order)
    x = np.empty(S)
    x[order] = np.arange(S)
    pos = np.stack([x, np.zeros(S), np.zeros(S)], axis=1)
    return Sinks.create(pos, np.random.default_rng(4).normal(0, 1, (S, 3)),
                        np.linspace(1.0, 2.0, S), 1.2, capacity=S,
                        dtype=dtype, device=device)


@pytest.mark.parametrize("case", CHAINS)
def test_merge_chain_roots_are_its_local_index_minima(case):
    order, roots = CHAINS[case]
    s = chain(order, "cpu", torch.float64)
    new_s, n_merged = sinks.merge_sinks_plain(s, CFG)
    assert int(n_merged) == len(order) - len(roots)
    assert torch.nonzero(new_s.alive).flatten().tolist() == roots


@pytest.mark.gpu
@pytest.mark.parametrize("case", CHAINS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_chain_needs_several_jumps(cuda_device, dtype, case):
    """The chains of CHAINS: the kernel equals the plain version, roots,
    absorbed count and all, and conserves the mass."""
    order, roots = CHAINS[case]
    s = chain(order, cuda_device, dtype)
    new_s, n_merged = check("merge_sinks", CFG, None, s, dtype,
                            exact={"0.alive", "0.radius", "0.acc"})
    assert int(n_merged) == len(order) - len(roots)
    assert torch.nonzero(new_s.alive).flatten().tolist() == roots
    hold("mass", new_s.mass.sum(), s.mass.sum(), s.mass.double().sum(),
         dtype)


@pytest.mark.gpu
def test_sink_kernels_raise_on_what_they_cannot_stage(cuda_device):
    p = gas(1024, cuda_device, torch.float32)
    s = slots(cuda_sinks.MAX_SLOTS + 1, "all", cuda_device, torch.float32)
    with pytest.raises(ValueError, match="sink slots"):
        gravity.sink_gravity(p, s)
    with pytest.raises(TypeError, match="float32 or float64"):
        sinks.merge_sinks(s.map(lambda t: t.half() if t.is_floating_point()
                                else t), CFG)
