"""The program's spans in a ``tracing.Trace``: the named ranges that
``visinger_tpu_torch/utils/meters.span`` records on the host around the
layers of a training step and of a synthesis call, on the clock of the
trace's kernels.

A span is a host operation whose name starts with ``train.``, ``model.``
or ``synth.``.  The device's idle time inside a span is the part of its
interval that no kernel interval covers, whatever thread launched the
kernels (autograd launches the backward's from a thread of its own).  A
trace of a program without spans holds none, and the readers here then
return None: the metric is left out."""

from __future__ import annotations

import bisect
import re

import readers

PROGRAM_SPAN = re.compile(r"^(train|model|synth)\.")
SYNC = re.compile(r"^cuda\w*Synchronize$")
OUTSIDE = "(outside the program's spans)"


def program_spans(trace) -> list:
    """[(name, start_us, end_us), ...] of the program's spans, by start."""
    return sorted((op for op in trace.host_ops if PROGRAM_SPAN.match(op[0])),
                  key=lambda op: op[1])


class Busy:
    """The union of the trace's kernel intervals, asked how much of a
    stretch it covers."""

    def __init__(self, kernels):
        self.starts, self.ends, self.before = [], [], [0.0]
        for _, start, stop in sorted(kernels, key=lambda k: k[1]):
            if self.ends and start <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], stop)
                continue
            if self.ends:
                self.before.append(self.before[-1]
                                   + self.ends[-1] - self.starts[-1])
            self.starts.append(start)
            self.ends.append(stop)

    def _until(self, t: float) -> float:
        """Busy microseconds before ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def covered(self, start: float, stop: float) -> float:
        return self._until(stop) - self._until(start)

    def extent(self):
        """(first kernel's start, last kernel's end), or None."""
        return (self.starts[0], self.ends[-1]) if self.starts else None


def span_seconds(trace, names) -> float | None:
    """Host seconds of the spans named in ``names``; None when there is
    none."""
    found = [s for s in program_spans(trace) if s[0] in names]
    if not found:
        return None
    return sum(stop - start for _, start, stop in found) / 1e6


def span_idle_seconds(trace, names) -> float | None:
    """Seconds of the spans named in ``names`` in which no kernel ran;
    None when there is no such span."""
    found = [s for s in program_spans(trace) if s[0] in names]
    if not found:
        return None
    busy = Busy(trace.kernels)
    return sum(stop - start - busy.covered(start, stop)
               for _, start, stop in found) / 1e6


def _innermost(spans, start: float, stop: float) -> str:
    """The name of the innermost span that holds [start, stop]: the one
    that started last, of two that started together the one that ends
    first."""
    held = [(s, -e, n) for n, s, e in spans if s <= start and stop <= e]
    return max(held)[2] if held else OUTSIDE


def idle_by_span(trace, n: int = 16) -> list:
    """[[span, seconds], ...]: the device's idle time between its first
    and last kernel, by the innermost program span the host was in, the
    ``n`` largest; idle time outside every span goes under ``OUTSIDE``."""
    busy = Busy(trace.kernels)
    spans = program_spans(trace)
    extent = busy.extent()
    if extent is None or not spans:
        return []
    lo, hi = extent
    cuts = sorted({lo, hi} | {t for _, s, e in spans for t in (s, e)
                              if lo < t < hi})
    by_name: dict[str, float] = {}
    for start, stop in zip(cuts, cuts[1:]):
        idle = stop - start - busy.covered(start, stop)
        if idle > 0:
            name = _innermost(spans, start, stop)
            by_name[name] = by_name.get(name, 0.0) + idle / 1e6
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:n]]


def syncs_by_span(trace) -> list:
    """[[span, count], ...]: the ``cuda*Synchronize`` runtime calls by the
    innermost program span they were made in."""
    spans = program_spans(trace)
    if not spans:
        return []
    by_name: dict[str, int] = {}
    for name, start, stop in trace.host_ops:
        if SYNC.match(name):
            where = _innermost(spans, start, start)
            by_name[where] = by_name.get(where, 0) + 1
    return [[k, v] for k, v in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])]


def span_ms(trace) -> dict:
    """{span: [host ms, idle ms] per traced unit} for every span name."""
    units = max(trace.units, 1)
    return {name: [1e3 * span_seconds(trace, (name,)) / units,
                   1e3 * span_idle_seconds(trace, (name,)) / units]
            for name in sorted({s[0] for s in program_spans(trace)})}


def per_unit_ms(reading, kind: str, names, idle: bool = False):
    """Host milliseconds (or with ``idle`` the device's idle milliseconds)
    of the spans ``names`` per traced step or call of a ``kind`` cell."""
    if not readers.traced(reading, kind) or not reading.trace.units:
        return None
    read = span_idle_seconds if idle else span_seconds
    seconds = read(reading.trace, names)
    return None if seconds is None else 1e3 * seconds / reading.trace.units
