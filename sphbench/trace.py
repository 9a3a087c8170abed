"""The reduction of a `torch.profiler` trace of the window to numbers.

The profile records the card's activity only (`ProfilerActivity.CUDA`:
the device's operations and the host's CUDA runtime calls), which costs
the host about a microsecond a launch, where recording every host
operation too would double a disc segment.  It is started just before
the first traced segment and stopped just after the last, so the traced
window is the span of its events.  Inside it:

* device intervals: every operation on the card (kernels, copies, sets);
  busy seconds are the length of their union, so overlapping operations
  count once;
* kernels: the device intervals that are kernel launches (not
  `Memcpy`/`Memset`), by the name the profiler prints; `kernel_name`
  takes the bare function name out of it;
* idle gaps: the holes in that union, each named by the innermost CUDA
  runtime call the host was in at its middle, or "host between runtime
  calls" (the Python of the program) when it was in none.
"""

from __future__ import annotations

import collections
import re

_ANON = re.compile(r"\(anonymous namespace\)::")


def _span(e):
    return e.time_range.start, e.time_range.end


def _is_device(e) -> bool:
    kind = getattr(e, "device_type", None)
    return kind is not None and "CUDA" in str(kind)


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def kernel_name(name: str) -> str:
    """The bare function name of a kernel as the profiler prints it:
    'void (anonymous namespace)::density_kernel<true, false>(float4
    const*, ...)' -> 'density_kernel'."""
    bare = _ANON.sub("", name)
    bare = bare[5:] if bare.startswith("void ") else bare
    bare = re.split(r"[<(]", bare, maxsplit=1)[0]
    return bare.rsplit("::", 1)[-1].strip()


class Trace:
    """The events of one profiled window (`prof.events()`)."""

    def __init__(self, events):
        self.device = []     # (start_us, end_us, name)
        self.host = []       # (start_us, end_us, name)
        for e in events:
            a, b = _span(e)
            if _is_device(e):
                if getattr(e, "is_user_annotation", False):
                    continue    # a marker's range on the device, no work
                self.device.append((a, b, e.name))
            else:
                self.host.append((a, b, e.name))
        if not self.device:
            raise ValueError("the profile holds no device operation")
        spans = self.device + self.host
        self.w0 = min(a for a, _, _ in spans)
        self.w1 = max(b for _, b, _ in spans)
        self.device.sort()
        self._union()

    def _union(self):
        merged = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_us = sum(b - a for a, b in merged)
        gaps = []
        last = self.w0
        for a, b in merged:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.w1 > last:
            gaps.append((last, self.w1))
        self.gaps = gaps

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    def kernels(self, stems=None):
        """[(name, seconds)] of the kernel launches, those whose bare
        function name (`kernel_name`) starts with one of `stems` if
        given."""
        out = []
        for a, b, name in self.device:
            if not _is_kernel(name):
                continue
            if stems is None or kernel_name(name).startswith(tuple(stems)):
                out.append((name, (b - a) * 1e-6))
        return out

    def top_ops(self, k=10):
        tot = collections.Counter()
        for a, b, name in self.device:
            tot[name] += (b - a) * 1e-6
        return [[name, s] for name, s in tot.most_common(k)]

    def _host_at(self, t):
        best = None
        for a, b, name in self.host:
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else "host between runtime calls"

    def top_gaps(self, k=10):
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:k]
        return [[self._host_at(0.5 * (a + b)), (b - a) * 1e-6]
                for a, b in longest]


__all__ = ["Trace", "kernel_name"]
