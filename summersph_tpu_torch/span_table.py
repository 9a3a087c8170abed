"""The program's spans and counters (`tracing.collect()`) reduced, with
the events of the torch profiler that recorded them, to numbers for each
span name.

The spans are moved onto the trace's axis (ns - the trace's
`trace_start_ns()`, in microseconds) and, for each span name:

* host ms: the spans' wall time, inclusive and self (less their child
  spans);
* device ms: the union of the device operations whose launching runtime
  call starts inside the span (a device operation's launch is the host
  event whose `id` is the operation's `linked_correlation_id`, or failing
  that its own `id`: the correlation id CUPTI gives a kernel and the call
  that launched it), inclusive (the span or a descendant launched it) and
  self (the innermost span around the launch is this one);
* launches: those device operations, inclusive and self;
* idle ms: the holes in the union of every device operation of the
  window, each put down to the innermost span the host was in at its
  midpoint (self) and to that span's ancestors too (inclusive).  A hole
  whose midpoint falls in the profiler's own `Activity Buffer Request`
  goes in a row of its own, and one outside every span in another.

The table keeps numpy arrays and a few hundred Python objects, not one
object per device operation, so that building it leaves the process's
heap much as it found it.

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_steps(state, cfg, 5)
        torch.cuda.synchronize()
    for line in span_table.table(prof, tracing.collect()).lines():
        print(line)
"""

from __future__ import annotations

import numpy as np

BUFFER_CALL = "Activity Buffer Request"
PROFILER_ROW = "(profiler_buffer)"
NO_SPAN_ROW = "(no_span)"
STEP = "step"


def _union(start, end) -> float:
    """Length of the union of the intervals [start, end) (arrays)."""
    if start.size == 0:
        return 0.0
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.concatenate(([-np.inf], np.maximum.accumulate(e)[:-1]))
    return float(np.sum(np.maximum(e - np.maximum(s, reach), 0.0)))


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    iv = np.asarray(list(intervals), dtype=np.float64).reshape(-1, 2)
    return _union(iv[:, 0], iv[:, 1])


class Row:
    """The numbers of one span name (µs; see the module docstring)."""

    __slots__ = ("count", "host_us", "host_self_us", "device_us",
                 "device_self_us", "launches", "launches_self", "idle_us",
                 "idle_self_us")

    def __init__(self):
        for k in self.__slots__:
            setattr(self, k, 0)


class Table:
    """The reduction of `collected` (`tracing.collect()`) with the profile's
    `events` (FunctionEvents, µs from the trace's start) and its
    `start_ns` (`trace_start_ns()`)."""

    def __init__(self, events, start_ns: int, collected: dict):
        self.counters = dict(collected["counters"])
        self.dropped = collected["dropped"]
        raw = collected["spans"]
        kept = [i for i, s in enumerate(raw) if s[4]]   # closed spans
        new = {old: i for i, old in enumerate(kept)}
        self.spans = [(raw[i][0], new.get(raw[i][1], -1), raw[i][2],
                       (raw[i][3] - start_ns) * 1e-3,
                       (raw[i][4] - start_ns) * 1e-3) for i in kept]
        self.names = list(dict.fromkeys(s[0] for s in self.spans))
        self._index = {n: k for k, n in enumerate(self.names)}
        self.rows = {n: Row() for n in self.names}
        self.steps = sum(1 for s in self.spans if s[0] == STEP)
        n_spans = len(self.spans)
        self._name = np.array([self._index[s[0]] for s in self.spans],
                              dtype=np.int64)
        # _chain[i, k]: span i or one of its ancestors is named names[k]
        self._chain = np.zeros((n_spans, len(self.names)), dtype=bool)
        for i, (_, parent, *_) in enumerate(self.spans):
            if parent >= 0:
                self._chain[i] = self._chain[parent]
            self._chain[i, self._name[i]] = True
        self._t0 = np.array([s[3] for s in self.spans], dtype=np.float64)
        self._t1 = np.array([s[4] for s in self.spans], dtype=np.float64)
        self._host_time()
        device, host = [], []
        for e in events:
            kind = getattr(e, "device_type", None)
            if kind is not None and "CUDA" in str(kind):
                if not getattr(e, "is_user_annotation", False):
                    device.append(e)
            else:
                host.append(e)
        self._device(device, host)
        self._idle(device, host)

    # ------------------------------------------------------------ host
    def _host_time(self):
        child_us = [0.0] * len(self.spans)
        for name, parent, _, a, b in self.spans:
            if parent >= 0:
                child_us[parent] += b - a
        for i, (name, _, _, a, b) in enumerate(self.spans):
            row = self.rows[name]
            row.count += 1
            row.host_us += b - a
            row.host_self_us += b - a - child_us[i]

    def innermost(self, times) -> np.ndarray:
        """Index of the innermost span around each of `times` (µs), -1
        where none is.  Spans nest, so a sweep keeps the open chain."""
        times = np.asarray(times, dtype=np.float64)
        out = np.full(times.size, -1, dtype=np.int64)
        order = np.argsort(self._t0, kind="stable").tolist()
        t0, t1 = self._t0.tolist(), self._t1.tolist()
        chain, j = [], 0
        q_sorted = np.argsort(times, kind="stable")
        for q, t in zip(q_sorted.tolist(), times[q_sorted].tolist()):
            while j < len(order) and t0[order[j]] <= t:
                chain.append(order[j])
                j += 1
            while chain and t1[chain[-1]] < t:
                chain.pop()
            if chain:
                out[q] = chain[-1]
        return out

    # ---------------------------------------------------------- device
    def _device(self, device, host):
        launch_us = {}
        for e in host:
            if e.id > 0:
                launch_us.setdefault(e.id, e.time_range.start)
        n = len(device)
        self._op_start = np.fromiter((e.time_range.start for e in device),
                                     np.float64, n)
        self._op_end = np.fromiter((e.time_range.end for e in device),
                                   np.float64, n)
        at = np.full(n, np.nan)
        for i, e in enumerate(device):
            for key in (getattr(e, "linked_correlation_id", 0), e.id):
                if key and key in launch_us:
                    at[i] = launch_us[key]
                    break
        launch_us = None
        linked = ~np.isnan(at)
        self._op_span = np.full(n, -1, dtype=np.int64)
        self._op_span[linked] = self.innermost(at[linked])
        self.device_ops = n
        self.device_ops_linked = int(linked.sum())
        inside = self._op_span >= 0
        self.device_ops_in_span = int(inside.sum())
        spans_of = self._op_span[inside]
        s, e = self._op_start[inside], self._op_end[inside]
        for name, row in self.rows.items():
            k = self._index[name]
            incl = self._chain[spans_of, k]
            own = self._name[spans_of] == k
            row.device_us = _union(s[incl], e[incl])
            row.device_self_us = _union(s[own], e[own])
            row.launches = int(incl.sum())
            row.launches_self = int(own.sum())
        self.busy_us = _union(self._op_start, self._op_end)

    def device_us(self, names) -> float:
        """The union of the device operations launched inside any span of
        `names` (inclusive)."""
        ks = [self._index[n] for n in names if n in self._index]
        if not ks:
            return 0.0
        inside = self._op_span >= 0
        hit = np.zeros(self._op_span.size, dtype=bool)
        hit[inside] = self._chain[self._op_span[inside]][:, ks].any(axis=1)
        return _union(self._op_start[hit], self._op_end[hit])

    # ------------------------------------------------------------ idle
    def _idle(self, device, host):
        self.window_us = 0.0
        if not device:
            return
        h0 = np.fromiter((e.time_range.start for e in host), np.float64,
                         len(host))
        h1 = np.fromiter((e.time_range.end for e in host), np.float64,
                         len(host))
        w0 = min(self._op_start.min(), h0.min(initial=np.inf))
        w1 = max(self._op_end.max(), h1.max(initial=-np.inf))
        self.window_us = float(w1 - w0)
        order = np.argsort(self._op_start, kind="stable")
        s, e = self._op_start[order], self._op_end[order]
        last = np.maximum(np.concatenate(([w0], np.maximum.accumulate(e))),
                          w0)
        hole = s > last[:-1]
        a, b = last[:-1][hole], s[hole]
        if w1 > last[-1]:
            a, b = np.append(a, last[-1]), np.append(b, w1)
        length, mid = b - a, 0.5 * (a + b)
        buffers = sorted((e.time_range.start, e.time_range.end)
                         for e in host if e.name == BUFFER_CALL)
        in_buffer = np.zeros(mid.size, dtype=bool)
        if buffers:
            b0 = np.array([x for x, _ in buffers])
            b1 = np.array([y for _, y in buffers])
            k = np.searchsorted(b0, mid, side="right") - 1
            in_buffer = (k >= 0) & (b1[np.maximum(k, 0)] >= mid)
        where = self.innermost(mid)
        for name, rest in ((PROFILER_ROW, in_buffer),
                           (NO_SPAN_ROW, ~in_buffer & (where < 0))):
            if rest.any():
                row = self.rows.setdefault(name, Row())
                row.idle_us = row.idle_self_us = float(np.sum(length[rest]))
        named = ~in_buffer & (where >= 0)
        length, where = length[named], where[named]
        for name in self.names:
            k = self._index[name]
            row = self.rows[name]
            row.idle_us = float(np.sum(length[self._chain[where, k]]))
            row.idle_self_us = float(np.sum(length[self._name[where] == k]))

    # ----------------------------------------------------------- report
    def step_child_share(self):
        """The share of the device time under `step` spans whose launch's
        innermost span is a named child, not a `step` itself; None
        without any."""
        under = self.rows.get(STEP)
        if under is None or under.device_us <= 0.0:
            return None
        return 1.0 - under.device_self_us / under.device_us

    def lines(self):
        """`span NAME ...` for each name (most inclusive device time
        first), `counter NAME VALUE` for each counter, then `spans: ...`
        with the attribution's coverage."""
        out = []
        for name, r in sorted(self.rows.items(),
                              key=lambda kv: (-kv[1].device_us, kv[0])):
            out.append(
                f"span {name} n={r.count} host_ms={r.host_us * 1e-3!r} "
                f"host_self_ms={r.host_self_us * 1e-3!r} "
                f"device_ms={r.device_us * 1e-3!r} "
                f"device_self_ms={r.device_self_us * 1e-3!r} "
                f"launches={r.launches} launches_self={r.launches_self} "
                f"idle_ms={r.idle_us * 1e-3!r} "
                f"idle_self_ms={r.idle_self_us * 1e-3!r}")
        for name, v in sorted(self.counters.items()):
            out.append(f"counter {name} {v}")
        share = self.step_child_share()
        out.append(
            f"spans: {len(self.spans)} spans ({self.dropped} dropped), "
            f"{self.steps} steps; device ops {self.device_ops}, linked to a "
            f"launch {self.device_ops_linked}, launched inside a span "
            f"{self.device_ops_in_span}; busy {self.busy_us * 1e-3!r} ms "
            f"of {self.window_us * 1e-3!r} ms; device time under step in "
            f"named children {share!r}")
        return out


def profile_start_ns(prof) -> int:
    """`trace_start_ns()` of a stopped torch profiler's results."""
    return prof.profiler.kineto_results.trace_start_ns()


def table(prof, collected) -> Table:
    """The Table of a stopped `torch.profiler.profile` and what
    `tracing.collect()` returned after it."""
    return Table(prof.events(), profile_start_ns(prof), collected)


__all__ = ["Table", "Row", "table", "union_us", "profile_start_ns",
           "BUFFER_CALL", "PROFILER_ROW", "NO_SPAN_ROW", "STEP"]
