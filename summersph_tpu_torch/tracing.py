"""Spans and counters inside the step, recorded while a torch profiler
records, on the profiler's clock.

    with tracing.span("eos"): ...          # a block
    @tracing.traced("sort")                # a whole function
    if tracing.active():                   # a counter's arithmetic
        tracing.count("sph_rows", torch.sum(p.alive))
    got = tracing.collect()                # after the profiled run

Tracing is on exactly while a torch profiler records
(`torch.autograd.profiler._is_profiler_enabled`); there is no flag of its
own.  Off, `span` returns one shared null context and `traced` calls the
function straight through: no clock read, allocation or device work.

On, a span appends [name, parent, step, t0_ns, t1_ns] to an in-memory
buffer: `parent` is the index of the span it opened inside (-1 for none),
`step` the running index of the `step` span (every span of one step
shares it; -1 before the first), and t0/t1 come from `time.time_ns()`,
the epoch clock the profiler stamps its events on: an event's time is its
trace's `trace_start_ns()` plus its microseconds.  The buffer holds at
most CAP spans and counts the ones it dropped.  `count` adds a device
scalar into a device accumulator of its name and never reads the device.
`collect()` makes the one host read, returns the spans, the counters as
Python ints and the dropped count, and clears all three.

The spans, at every layer boundary of every path (one device, gather
mode, the slab decomposition, the dense engine, block steps): `prime`,
`segment` (`run_steps`), `step` (`integrate._step`, and the block
engine's base step with a `substep` child per substep), `kick`, `drift`,
`force_eval`, `sort`, `density`, `eos`, `force`, `gravity_direct`,
`pm_long_range` (a solve; a held step opens none; its children
`pm_deposit`, `pm_poisson`, `pm_gradient`, `pm_gather`), `grav_short`
(with its `grav_sort` child), `sink_gravity`, `timestep`, `h_iter`,
`create_sinks`, `accrete`, `merge_sinks`, `cull`, `stats`, and on a mesh
`gather`, `redistribute` and `exchange_rim`.  The counters, one increment
per sort: `sph_candidates` (window extents x window_group) and `sph_rows`
(live rows) in `sort_particles`, `grav_candidates` and `grav_rows` in
`gravity_sort`; ten small device operations a sort (six or seven of them
kernels, the rest the reductions' memsets), only while a profiler
records.

The system's other counters stay where they are, read by the tests and
the benchmark: the kernel launch counts (`ops.cuda_pairs.launch_counters`,
`pack_force.launches`, `ops.cuda_sinks.launch_counters`,
`ops.pm_gravity.fd4_gradient_cuda.launches`), the mesh solves
(`pm_long_range.solves`, `pencil_solves`) and the device health counters
(`state.stats`, `state.STATS_FIELDS`).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.autograd.profiler as _profiler

CAP = 1 << 20      # spans the buffer holds between two collects

_spans: list = []      # [name, parent, step, t0_ns, t1_ns]
_open: list = []       # buffer indices of the open spans, innermost last
_counters: dict = {}   # name -> int64 device accumulator
_dropped = 0
_step = -1
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "idx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped, _step
        if self.name == "step":
            _step += 1
        if len(_spans) >= CAP:
            _dropped += 1
            self.idx = -1
        else:
            self.idx = len(_spans)
            _spans.append([self.name, _open[-1] if _open else -1, _step,
                           time.time_ns(), 0])
        _open.append(self.idx)
        return None

    def __exit__(self, *exc):
        if self.idx >= 0:
            _spans[self.idx][4] = time.time_ns()
        _open.pop()
        return False


def active() -> bool:
    """Whether a torch profiler records, and so spans and counters."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager that records the span `name` while a profiler
    records, and a shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def traced(name: str):
    """Decorator: the function's call is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value: torch.Tensor) -> None:
    """Add the device scalar `value` into the counter `name` while a
    profiler records; nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return
    acc = _counters.get(name)
    if acc is None:
        _counters[name] = value.reshape(()).to(torch.int64, copy=True)
    else:
        acc.add_(value.reshape(()))


def collect() -> dict:
    """{'spans': [(name, parent, step, t0_ns, t1_ns)], 'counters': {name:
    int}, 'dropped': int} of everything recorded since the last collect,
    which is cleared; one host read of the counters.  A span still open
    has t1_ns 0."""
    global _dropped, _step
    names = list(_counters)
    values = (torch.stack([_counters[k] for k in names]).tolist()
              if names else [])
    out = {"spans": [tuple(s) for s in _spans],
           "counters": dict(zip(names, values)), "dropped": _dropped}
    _spans.clear()
    _open.clear()
    _counters.clear()
    _dropped, _step = 0, -1
    return out


__all__ = ["CAP", "active", "span", "traced", "count", "collect"]
