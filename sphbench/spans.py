"""The program's spans and counters, read for the per-layer metrics.

The program records a span at each layer boundary of its step while a
torch profiler records (`summersph_tpu_torch.tracing`), and reduces them
with the profile to numbers for each span name
(`summersph_tpu_torch.span_table`: host, device and idle ms and launches,
inclusive and self).  Here `of(ctx)` finds the profile of the run (the one
torch profiler object alive with results), collects the program's spans
once, prints one `span ...` line per name and one `counter ...` line per
counter on standard output, before the result line, and keeps the table
on the context for the other readers.  The readers that time calls of
their own after it (`h_iter_ms_per_step`, `pm_ms_per_solve`,
`sinks_ms_per_step`) read the same with the table built and without it
(PERF.md §6).

A program without `tracing` (an older checkout) gives no table: the
readers that use it return None and nothing raises.

The table moves the spans onto the trace's axis (ns - `trace_start_ns()`)
and gives, for each span name, its host ms (inclusive and self), its
device ms (the union of the device operations whose launching runtime
call starts inside it, by correlation id; inclusive and self), its
launches, and its idle ms (each hole in the device union put down to the
innermost span at its midpoint; holes in the profiler's own `Activity
Buffer Request` get the row `(profiler_buffer)`, holes outside every span
`(no_span)`).  A `--trace 1` run prints, before the result line:

    span NAME n=... host_ms=... host_self_ms=... device_ms=...
         device_self_ms=... launches=... launches_self=... idle_ms=...
         idle_self_ms=...                       (one line each, ms of the
                                                 traced segments)
    counter NAME VALUE
    spans: S spans (D dropped), K steps; device ops ..., linked to a
           launch ..., launched inside a span ...; busy ... ms of ... ms;
           device time under step in named children ...

The eight readers that use it (`metrics/<name>.py`):

| Metric | Source | Cells | Reads, over the traced steps |
|---|---|---|---|
| `host_ms_per_step` | program_span | both | host wall of `step` spans / steps |
| `step_idle_ms_per_step` | program_span | both | idle put down to `step` and its descendants (profiler buffer holes excluded) / steps |
| `sort_ms_per_step` | program_span | both | device ms of `sort` / steps |
| `sinks_span_ms_per_step` | program_span | both | device ms, as one union, of `sink_gravity`, `create_sinks`, `accrete`, `merge_sinks` / steps |
| `h_iter_span_ms_per_step` | program_span | collapse | device ms of `h_iter` / steps |
| `pm_span_ms_per_solve` | program_span | collapse | device ms of `pm_long_range` / its spans |
| `sph_candidates_counted_per_row` | program_counter | both | `sph_candidates` / `sph_rows` |
| `grav_candidates_counted_per_row` | program_counter | collapse | `grav_candidates` / `grav_rows` |

`h_iter_ms_per_step`, `pm_ms_per_solve`, `sinks_ms_per_step` and
`sph_candidates_per_row` are the same layers timed or counted by the
benchmark's own calls on the window's end state; their `source` labels
are the benchmark's, kept until a change of the benchmark corrects or
retires them.  The attribution's own tests are the program's
`tests/test_torch_span_table.py`; `tests/test_spans.py` here holds this
wrapper under a CPU profiler.
"""

from __future__ import annotations

import gc
import importlib
import warnings


def program_tables():
    """The program's (tracing, span_table) modules, or None where it has
    them not."""
    try:
        return (importlib.import_module("summersph_tpu_torch.tracing"),
                importlib.import_module("summersph_tpu_torch.span_table"))
    except ImportError:
        return None


def _the_profile():
    """The one stopped torch profiler with results alive in this process,
    or None where there is none or more than one."""
    from torch.profiler import profile

    with warnings.catch_warnings():   # isinstance on deprecated aliases
        warnings.simplefilter("ignore", FutureWarning)
        found = [o for o in gc.get_objects() if isinstance(o, profile)
                 and getattr(getattr(o, "profiler", None), "kineto_results",
                             None) is not None]
    return found[0] if len(found) == 1 else None


def of(ctx):
    """The run's Table, made once per context (see the module
    docstring); None without the program's tracing or a profile."""
    if "_spans_table" in vars(ctx):
        return ctx._spans_table
    got = None
    mods = program_tables()
    prof = _the_profile() if mods is not None else None
    if prof is not None:
        tracing, span_table = mods
        got = span_table.table(prof, tracing.collect())
        if not got.spans:
            got = None
        else:
            for line in got.lines():
                print(line, flush=True)
    ctx._spans_table = got
    return got


def per_step(ctx, value):
    """`value(table)` / the traced steps, on the card only; None where
    the table, a step or the value is missing."""
    t = of(ctx) if ctx.on_card else None
    if t is None or not t.steps or not t.device_ops:
        return None
    v = value(t)
    return None if v is None else v / t.steps


def ratio(ctx, num: str, den: str):
    """counters[num] / counters[den] of the run's Table; None where either
    is missing or the denominator is 0."""
    t = of(ctx)
    if t is None or not t.counters.get(den) or num not in t.counters:
        return None
    return t.counters[num] / t.counters[den]


__all__ = ["of", "per_step", "ratio", "program_tables"]
