"""The comparison that decides `correct`, held to fail where it must.

Run on the CPU at each configuration's rehearsal size (the kernels'
plain versions), from the repository's root:

    python -m pytest sphbench/tests -q

* the control: the plain reference computed in bfloat16, put in the
  program's place, fails the cell's limits;
* a whole run (`run.main`, the look for a card skipped) with the timed
  path sound comes out correct, and with it broken underneath comes out
  not correct, once for each fault a cell can have: a segment that
  returns its state unchanged, one that advances half the particles and
  leaves the rest as they were, one whose answer is altered where it
  is produced (one particle moved), and, with variable h, one that skips
  the h-iteration (`faults.py`).  One chip runs each cell, so there is
  no exchange between chips to leave out.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sphbench import compare, faults, run  # noqa: E402

N = 4096
CELLS = ("kepler_disc.n1m.sph", "collapse.n1m.early")
SEED = 2147483659


def _run(workload):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(SEED),
                       "--seconds", "0.1", "--trace", "0"], device="cpu",
                      n=N)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    c = run.Cell(workload, device="cpu", n=N)
    w = c.window(c.start(SEED), SEED, segments=1)
    (_, d_in, _), = c.samples(w)
    ref = c.reference(d_in)
    ctrl = c.compare(d_in, c.reference(d_in, torch.bfloat16), ref)
    ok, lines = compare.judge(ctrl, c.wl["limits"])
    assert not ok, lines


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def _var_h(workload):
    return run.load("configs", run.load("workloads", workload)["config"])[
        "sim"]["fixed_h"] is None


FAULT_CASES = [(w, f) for w in CELLS for f in faults.NAMES
               if f not in faults.VARIABLE_H_ONLY or _var_h(w)]


@pytest.mark.parametrize("workload,fault", FAULT_CASES)
def test_fault_is_caught(workload, fault, monkeypatch):
    from summersph_tpu_torch import integrate

    for name in ("run_steps", "update_smoothing"):
        monkeypatch.setattr(integrate, name, getattr(integrate, name))
    faults.plant(integrate, fault)
    res = _run(workload)
    assert not res["correct"], res["checks"]
