"""The Sod evidence of the port (`summersph_tpu_torch/tools/
sod_evidence.py`) against `scripts/sod_evidence.py`: each case's config
field for field, the L2 at n = 400 on both engines on the CPU, the
profiles' arrays, the figure drawn from them, and the missing card.

The module's top level imports no JAX: the script is imported inside the
test that needs it.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from summersph_tpu_torch.tools import sod_evidence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "sod_evidence.py")


class _Built(Exception):
    def __init__(self, kw):
        self.kw = kw


def _caught(*args, **kw):
    raise _Built(kw)


@pytest.mark.parametrize("n,mode", sod_evidence.CASES)
def test_case_config_matches_script(monkeypatch, n, mode):
    """The config each case hands to sod_ic equals the script's, caught
    there (the script imports sod_ic inside run_case)."""
    import summersph_tpu.models.sod as jsod

    monkeypatch.syspath_prepend(os.path.dirname(SCRIPT))
    sys.modules.pop("sod_evidence", None)
    try:
        mod = importlib.import_module("sod_evidence")
    finally:
        sys.modules.pop("sod_evidence", None)
    monkeypatch.setattr(jsod, "sod_ic", _caught)
    with pytest.raises(_Built) as theirs:
        mod.run_case(n, mode)
    monkeypatch.setattr(sod_evidence, "sod_ic", _caught)
    with pytest.raises(_Built) as ours:
        sod_evidence.run_case(n, mode, device="cpu")
    theirs, ours = theirs.value.kw, ours.value.kw
    assert (dataclasses.asdict(ours.pop("cfg"))
            == dataclasses.asdict(theirs.pop("cfg")))
    assert ours.pop("device") == "cpu"
    assert ours == theirs == {"n": n}


@pytest.mark.parametrize("mode", ["grid", "sorted"])
def test_l2_at_400_on_both_engines(mode):
    """`run_case` on the CPU (float32): the L2 density error at n = 400,
    t = 0.1 within L2_BOUND (5e-4) of the JAX package's 0.01383
    (docs/results/sod/README.md), every particle alive."""
    err, wall = sod_evidence.run_case(400, mode, device="cpu")
    assert abs(err - sod_evidence.JAX_L2[400]) <= sod_evidence.L2_BOUND, err
    assert wall > 0.0


def test_profiles_in_x_order():
    """`profiles` at a small n and t: the particles' x ascending, every
    field finite, t reached."""
    prof = sod_evidence.profiles(n=64, device="cpu", t_end=0.005)
    assert prof["t"] >= 0.005 and prof["n"] == 64
    assert np.all(np.diff(prof["x"]) > 0)
    for key in ("rho", "v", "pressure"):
        assert prof[key].shape == (64,) and np.all(np.isfinite(prof[key]))


def test_render_draws_the_profiles(tmp_path):
    """`--render` draws sod_profiles.png from a run's profiles.npz."""
    pytest.importorskip("matplotlib")
    x = np.linspace(-0.6, 0.6, 50)
    np.savez_compressed(tmp_path / "profiles.npz", n=50, t=0.2, x=x,
                        rho=np.ones(50), v=np.zeros(50),
                        pressure=np.ones(50))
    assert sod_evidence.main(["--render", str(tmp_path)]) == 0
    assert (tmp_path / "sod_profiles.png").stat().st_size > 1000


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """The default --device cuda raises where torch sees no card, before
    anything is run or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sod_evidence.main(["--out", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")
