"""The config-5 collapse of test_torch_collapse.py on a run where sinks are
created and merged, against the JAX package in float64 on the CPU: prime
+ 1 and prime + 10 steps at N = 2048.

Two real sinks start inside each other's merge distance (0.85 AU apart,
radii 1.5 AU), so they merge on the first step and free a slot, and the
creation threshold `sink_create_density` is lowered to 3e-4, below the
densest particles' m (eta / h)^3 (about 3.7e-4 after the first
h-iteration; config 5's own threshold is 0.5), so the densest eligible
particle spawns a sink and the new sinks accrete their neighbourhood.  The
JAX run shows both events, so the comparison cannot pass vacuously.
"""

import numpy as np
import pytest

from summersph_tpu.config import SimConfig as JaxConfig
from summersph_tpu.models.disc import collapse_ic as jax_collapse_ic
from summersph_tpu.state import Sinks as JSinks
from summersph_tpu_torch import state as tstate
from summersph_tpu_torch.config import SimConfig
from summersph_tpu_torch.integrate import check_health

from test_torch_collapse import (N, collapse_state, compare, config5_kw,
                                 run_both)
from test_torch_config_state import jax_state_dict

CREATE_DENSITY = 3e-4


@pytest.fixture(scope="module")
def runs():
    kw = config5_kw(sink_create_density=CREATE_DENSITY)
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    # the zero-mass dummy sink of the IC, then two real sinks to merge
    js = JSinks.create(pos=[[0.0, 0, 0], [20.0, 0, 0], [20.8, 0.3, 0]],
                       vel=[[0.0, 0, 0], [0, 1.0, 0], [0, 0.5, 0.2]],
                       mass=[0.0, 0.3, 0.2], radius=[0.0, 1.5, 1.5],
                       capacity=jcfg.sink_capacity, dtype=np.float64)
    jst = collapse_state(jax_collapse_ic, jcfg).replace(sinks=js)
    st = tstate.from_numpy(jax_state_dict(jst), device="cpu")
    return run_both(jcfg, cfg, jst, st) + (jst,)


def test_jax_run_creates_and_merges_sinks(runs):
    """Slot 2 is absorbed into slot 1 on step 1 with the mass of both;
    creation fills new slots with sinks that grew from the seed mass."""
    ic = runs[2].sinks
    after = {k: runs[1][k]["sinks"] for k in ("1", "10")}
    assert after["1"]["mass"][1] == pytest.approx(0.5)
    created = after["10"]["alive"] & ~np.asarray(ic.alive)
    assert created.sum() >= 1
    assert after["1"]["alive"][3]                       # created on step 1
    assert np.all(after["10"]["mass"][created] > 1e3 * 1e-11)
    # slot 2 died in the merge and was reused by a later creation
    assert not after["1"]["alive"][2] and after["10"]["alive"][2]


@pytest.mark.parametrize("n_steps,rtol", [("1", 1e-9), ("10", 1e-7)])
def test_sink_steps_match_jax(runs, n_steps, rtol):
    compare(runs[0][n_steps], runs[1][n_steps], rtol)


def test_sink_run_conserves_mass(runs):
    """Gas lost equals gas accreted: every particle has one mass, and the
    gas plus sink mass is the initial total plus the created seeds."""
    st = runs[0]["10"]
    check_health(st)
    m_p = 50.0 / N
    n_lost = N - int(st.particles.n_alive)
    assert n_lost > 0
    total = float(st.particles.mass.sum() + st.sinks.mass.sum())
    created = int(st.sinks.n_alive) - 3 + 1     # one merge freed a slot
    assert total == pytest.approx(50.0 + 0.5 + created * 1e-11, rel=1e-12)
    assert float(st.sinks.mass.sum()) == pytest.approx(
        0.5 + n_lost * m_p + created * 1e-11, rel=1e-12)
