"""`spans.py`, the readers' way to the program's span table: it finds the
run's one profile, collects the program's spans once, prints their lines,
keeps the table on the context, and gives None without the program's
tracing.  On the CPU, under a CPU profiler (no device operations).

    python -m pytest sphbench/tests -q
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sphbench import spans  # noqa: E402
from summersph_tpu_torch import tracing  # noqa: E402


def recorded():
    """A stopped CPU profile holding one `step` span with a `sort` child,
    and the two sort counters."""
    tracing.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("step"):
            with tracing.span("sort"):
                torch.sort(torch.arange(8.0).flip(0))
                tracing.count("sph_candidates", torch.tensor(300))
                tracing.count("sph_rows", torch.tensor(3))
    return prof


def test_of_collects_once_prints_and_keeps_the_table(capsys):
    prof = recorded()
    ctx = SimpleNamespace(on_card=False)
    t = spans.of(ctx)
    assert t is not None and t.steps == 1
    assert [s[0] for s in t.spans] == ["step", "sort"]
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("span step n=1 ") for line in out)
    assert "counter sph_candidates 300" in out
    assert out[-1].startswith("spans: 2 spans (0 dropped), 1 steps")
    assert spans.of(ctx) is t                      # made once
    assert capsys.readouterr().out == ""
    assert spans.ratio(ctx, "sph_candidates", "sph_rows") == 100.0
    assert spans.ratio(ctx, "grav_candidates", "grav_rows") is None
    assert spans.per_step(ctx, lambda _: 1.0) is None   # off the card
    del prof


def test_without_the_programs_tracing_nothing_is_read(monkeypatch):
    prof = recorded()
    monkeypatch.setattr(spans, "program_tables", lambda: None)
    ctx = SimpleNamespace(on_card=True)
    assert spans.of(ctx) is None
    assert spans.ratio(ctx, "sph_candidates", "sph_rows") is None
    assert spans.per_step(ctx, lambda _: 1.0) is None
    tracing.collect()
    del prof
