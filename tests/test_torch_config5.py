"""The config 5 evidence run of the port (`summersph_tpu_torch/tools/
config5.py`) against `scripts/config5_run.py`: the config and the ICs'
arguments field for field, the ledger's header and formats, the resume
from a checkpoint bit for bit, the stop and abort rules; and the CIC
deposit's bits on the card.

The module's top level imports no JAX (the script is imported inside the
tests that need it), so the `gpu` test collects on the card's machine:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_config5.py
"""

import ast
import csv
import dataclasses
import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

from summersph_tpu_torch.integrate import prime
from summersph_tpu_torch.io.checkpoint import load_npz
from summersph_tpu_torch.ops import pm_gravity
from summersph_tpu_torch.state import to_numpy
from summersph_tpu_torch.tools import config5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "config5_run.py")
N_SMALL = 1024   # the resume check's N on the CPU (2-step segments)


class _Built(Exception):
    def __init__(self, kw):
        self.kw = kw


def _caught(*args, **kw):
    raise _Built(kw)


def _script(monkeypatch, n, smoke):
    """scripts/config5_run.py imported with C5_N = n and C5_SMOKE set (it
    reads them when imported), dropped from sys.modules after."""
    monkeypatch.setenv("C5_N", str(n))
    monkeypatch.setenv("C5_SMOKE", "1" if smoke else "0")
    monkeypatch.syspath_prepend(os.path.dirname(SCRIPT))
    sys.modules.pop("config5_run", None)
    try:
        return importlib.import_module("config5_run")
    finally:
        sys.modules.pop("config5_run", None)


@pytest.mark.parametrize("n,smoke", [(1048576, False), (2048, False),
                                     (2048, True)])
def test_build_matches_config5_run(monkeypatch, n, smoke):
    """build()'s SimConfig and disc_ic arguments equal the script's, caught
    where each hands them to disc_ic; no ICs are made."""
    script = _script(monkeypatch, n, smoke)
    monkeypatch.setattr(script, "disc_ic", _caught)
    with pytest.raises(_Built) as theirs:
        script.build()
    monkeypatch.setattr(config5, "disc_ic", _caught)
    with pytest.raises(_Built) as ours:
        config5.build(n, smoke, device="cpu")
    theirs, ours = theirs.value.kw, ours.value.kw
    assert (dataclasses.asdict(ours.pop("cfg"))
            == dataclasses.asdict(theirs.pop("cfg")))
    assert ours.pop("device") == "cpu"
    assert ours == theirs
    assert config5.T_END == script.T_END


def _script_row_code():
    """The script's statements from `d = measure(state)` to the ledger
    row's assignment, from its source."""
    with open(SCRIPT) as fh:
        src = fh.read()
    loop = next(node for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.While))
    body = loop.body
    first = next(i for i, st in enumerate(body)
                 if isinstance(st, ast.Assign)
                 and ast.unparse(st.targets[0]) == "d")
    last = next(i for i, st in enumerate(body)
                if isinstance(st, ast.Assign)
                and ast.unparse(st.targets[0]) == "row")
    return "\n".join(ast.unparse(st) for st in body[first:last + 1]), src


def test_ledger_header_and_row_match_script(monkeypatch):
    """LEDGER_COLUMNS is the script's `cols`, and ledger_row formats a
    state as the script's own statements format the same state through
    the JAX package's `measure` (both sum in float64 here)."""
    from test_torch_config_state import jax_state_dict

    from summersph_tpu_torch.state import from_numpy

    code, src = _script_row_code()
    cols = next(node.value for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.Assign)
                and ast.unparse(node.targets[0]) == "cols")
    assert config5.LEDGER_COLUMNS == ast.literal_eval(cols)

    script = _script(monkeypatch, 512, True)
    js, _ = script.build()
    ns = {"state": js, "measure": script.measure, "jnp": script.jnp,
          "np": np, "t0": 8.75, "time": types.SimpleNamespace(
              time=lambda: 10.0), "step_count": 0,
          "args": types.SimpleNamespace(steps_per_seg=16)}
    exec(code, ns)
    ours = config5.ledger_row(from_numpy(jax_state_dict(js), device="cpu"),
                              1.25)
    assert [str(x) for x in ours] == [str(x) for x in ns["row"]]
    assert len(ours) == len(config5.LEDGER_COLUMNS)


def _flat(state):
    d = to_numpy(state)
    out = {f"{g}.{k}": v for g in ("particles", "sinks")
           for k, v in d.pop(g).items()}
    out.update(d)
    return out


def _ledger(out_dir):
    with open(os.path.join(out_dir, "ledger.csv")) as fh:
        return list(csv.reader(fh))


@pytest.mark.parametrize("pm_every", [1, 4])
def test_resumed_segment_equals_uninterrupted(tmp_path, pm_every):
    """At N = 1024 with the script's smoke config on the CPU (and with the
    mesh solved every 4th step, whose held force and split the checkpoint
    carries): 2 segments, the checkpoint, then 1 segment resumed by `run`
    end bit for bit where 3 uninterrupted segments end, in every field of
    the checkpoint; the ledgers agree but for the wall column."""
    state, cfg = config5.build(N_SMALL, smoke=True, device="cpu")
    cfg = cfg.with_(pm_every=pm_every)
    state = prime(state, cfg)
    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    for out, segs in ((whole, 3), (split, 2)):
        os.makedirs(out)
        assert config5.run_segments(state, cfg, out, steps_per_seg=2,
                                    max_segments=segs)[1] == 0
    assert config5.run(split, steps_per_seg=2, device="cpu",
                       max_segments=1) == 0
    a, b = (_flat(load_npz(os.path.join(d, "checkpoint.npz"), device="cpu"))
            for d in (whole, split))
    assert a.keys() == b.keys()
    assert "particles.u_c" in a
    assert ("pm_r_s" in a) == ("particles.acc_ext" in a) == (pm_every > 1)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    lw, ls = _ledger(whole), _ledger(split)
    assert lw[0] == config5.LEDGER_COLUMNS and len(lw) == len(ls) == 4
    assert [r[:-1] for r in lw] == [r[:-1] for r in ls]


def test_stop_t_stops_the_loop(tmp_path):
    """The first segment that reaches stop_t is the last; the checkpoint
    holds its state."""
    out = str(tmp_path)
    code = config5.run(out, steps_per_seg=1, fresh=True, stop_t=1e-9,
                       device="cpu", n=512, smoke=True)
    rows = _ledger(out)
    assert code == 0 and len(rows) == 2
    saved = load_npz(os.path.join(out, "checkpoint.npz"), device="cpu")
    assert f"{float(saved.t):.6f}" == rows[1][0] and float(saved.t) > 0.0


def test_diverged_state_writes_checkpoint_and_exits_2(tmp_path):
    """A live particle's u made non-finite: the segment is logged, the
    checkpoint written, and the exit code is 2."""
    state, cfg = config5.build(512, smoke=True, device="cpu")
    state = prime(state, cfg)
    p = state.particles
    bad = int(torch.nonzero(p.alive)[0])
    state = state.replace(particles=p.replace(
        u=p.u.index_fill(0, torch.tensor([bad]), float("nan"))))
    out = str(tmp_path)
    _, code = config5.run_segments(state, cfg, out, steps_per_seg=1,
                                   max_segments=4)
    assert code == 2
    assert len(_ledger(out)) == 2
    saved = load_npz(os.path.join(out, "checkpoint.npz"), device="cpu")
    assert saved.stats_dict()["nonfinite"] > 0


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """The default --device cuda raises where torch sees no card, before
    anything is built or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("C5_OUT", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        config5.main([])
    assert not os.path.exists(tmp_path / "out")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_deposit_is_bitwise_reproducible_on_the_card(cuda_device):
    """Two CIC deposits of config 5's 1,048,576 particles at grid 128 on
    the card, and one of the rows reversed, have equal bits."""
    state, cfg = config5.build(device=cuda_device)
    p = state.particles
    origin, cell, _ = pm_gravity.pm_geometry(p, cfg)
    m = torch.where(p.alive, p.mass, 0.0)
    n = cfg.grav_grid
    a = pm_gravity._cic_deposit(p.pos, m, origin, cell, n)
    b = pm_gravity._cic_deposit(p.pos, m, origin, cell, n)
    c = pm_gravity._cic_deposit(p.pos.flip(0), m.flip(0), origin, cell, n)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    torch.testing.assert_close(a.sum().double(), m.sum().double(),
                               rtol=1e-6, atol=0.0)
