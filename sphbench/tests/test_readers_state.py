"""The per-layer readers read the states the trace timed, not the
window's end state: with the same seed and the same traced segments, a
short window and a long one give the readers the same states, the same
pair counts and the same readings.  A window without a trace holds no
state beyond its end state and its sample, and a run drops the traced
states before the reference runs.  A run that holds JAX or the JAX
package once its window has closed gives no result.

On the CPU at each configuration's rehearsal size (the kernels' plain
versions), from the repository's root:

    python -m pytest sphbench/tests -q
"""

import contextlib
import io
import json
import sys
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sphbench import run  # noqa: E402
from sphbench.metrics import sph_candidates_per_row  # noqa: E402

N = 4096
CELLS = ("kepler_disc.n1m.sph", "collapse.n1m.early")
SEED = 2147483659
K_TRACE = 2
WINDOWS = (3, 8)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CELLS)
def started(request):
    """A cell at n particles and its state after set-up, shared by the
    tests: a state is never written after it is made."""
    c = run.Cell(request.param, device="cpu", n=N)
    return c, c.start(SEED)


def kinds(c):
    """The pair kinds the cell's readers count: the SPH kinds, and the
    short range's where the configuration runs TreePM."""
    extra = ("gravity",) if c.cfg.gravity in c.prog.pm_gravity.PM_MODES else ()
    return ("density", "force") + extra


def _program_states(w):
    """{attribute: state} of the window's namespace that are program
    states, and the states of its sample."""
    state_type = type(w.state)
    named = {k: v for k, v in vars(w).items() if isinstance(v, state_type)}
    kept = [s for _, a, b in w.kept for s in (a, b)]
    return named, kept


def test_readers_read_the_traced_span_whatever_the_window(started, capsys):
    c, s0 = started
    got = []
    for segments in WINDOWS:
        w = c.window(s0, SEED, segments=segments, k_trace=K_TRACE)
        assert w.segments == segments and w.traced == K_TRACE
        ctx = c.context(w)
        assert ctx.state_in is s0 and ctx.state is not w.state
        pairs = {k: ctx.pairs(k) for k in kinds(c)}
        got.append({"t_in": float(ctx.state_in.t), "t": float(ctx.state.t),
                    "pairs": pairs,
                    "sph_candidates_per_row": sph_candidates_per_row.read(
                        ctx),
                    "t_end": w.t1})
        w.prof = None
    short, long_ = got
    assert long_["t_end"] > short["t_end"] > short["t"] > short["t_in"]
    for key in ("t_in", "t", "pairs", "sph_candidates_per_row"):
        assert short[key] == long_[key], key
    err = capsys.readouterr().err.splitlines()
    for kind in kinds(c):
        lines = [s for s in err if s.startswith(f"pairs {kind}: t ")]
        assert len(lines) == len(WINDOWS), err
        assert " -> " in lines[0] and ", mean " in lines[0]


def test_untraced_window_holds_no_more_states(started):
    c, s0 = started
    w = c.window(s0, SEED, segments=3)
    named, kept = _program_states(w)
    assert set(named) == {"state"}
    assert w.traced_in is None and w.traced_out is None and w.prof is None
    assert len(kept) == 2 * int(c.traffic["check_segments"])


def test_run_drops_the_traced_states_before_the_reference(monkeypatch):
    seen = []
    samples = run.Cell.samples

    def spy(self, w):
        seen.append((w.traced_in, w.traced_out))
        return samples(self, w)

    monkeypatch.setattr(run.Cell, "samples", spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                       "--seconds", "0.1", "--trace", "1"], device="cpu",
                      n=N)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert "sph_candidates_per_row" in res["metrics"]
    assert seen == [(None, None)]


@pytest.mark.parametrize("planted, found", [
    (("jax", "jax.numpy"), ["jax"]),
    (("jaxlib",), ["jaxlib"]),
    (("flax.linen",), ["flax"]),
    (("summersph_tpu", "summersph_tpu.ops"), ["summersph_tpu"]),
    (("summersph_tpux", "jax_like", "summersph_tpu_torch.ops"), []),
])
def test_jax_modules_by_whole_top_level_name(monkeypatch, planted, found):
    for name in run.JAX_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    for name in planted:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.jax_modules() == found


def test_run_holding_jax_gives_no_result(monkeypatch, capsys):
    assert run.jax_modules() == []
    samples = run.Cell.samples

    def load_jax(self, w):             # a module loaded during the run
        monkeypatch.setitem(sys.modules, "jax.numpy",
                            types.ModuleType("jax.numpy"))
        return samples(self, w)

    monkeypatch.setattr(run.Cell, "samples", load_jax)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "0.1", "--trace", "0"], device="cpu", n=N)
    out, err = capsys.readouterr()
    assert rc != 0
    assert not any(line.startswith("{") for line in out.splitlines()), out
    assert "holds jax" in err.splitlines()[-1]
