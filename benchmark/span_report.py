#!/usr/bin/env python3
"""One run of a cell as ``run.py`` makes it, whose ``breakdown`` also
reads the program's spans in the traced stretch:

    python3 benchmark/span_report.py --workload <cell> --seed <n> \
        --seconds <s> --trace 1

- ``idle_by_span``: the device's idle seconds by the innermost span the
  host was in;
- ``syncs_by_span``: the ``cuda*Synchronize`` calls by innermost span;
- ``span_ms``: each span's host and idle milliseconds per traced step or
  call.

Everything else, the last line included, is ``run.py``'s.  A program
without spans gives the three empty."""

from __future__ import annotations

import contextlib
import sys

import run
import spans
import synth_cell
import tracing
import train_cell


@contextlib.contextmanager
def capture():
    """Meanwhile, every trace the cell modules take, in the list yielded."""
    traces = []
    saved = train_cell.profile, synth_cell.profile

    def traced(*args, **kwargs):
        traces.append(tracing.profile(*args, **kwargs))
        return traces[-1]

    # the cell modules took ``profile`` by name when they were imported
    train_cell.profile = synth_cell.profile = traced
    try:
        yield traces
    finally:
        train_cell.profile, synth_cell.profile = saved


def span_breakdown(trace) -> dict:
    return {"idle_by_span": spans.idle_by_span(trace),
            "syncs_by_span": spans.syncs_by_span(trace),
            "span_ms": spans.span_ms(trace)}


def main(argv=None) -> int:
    emit = run.emit
    with capture() as traces:
        def emit_with_spans(result):
            if traces and "breakdown" in result:
                result["breakdown"].update(span_breakdown(traces[-1]))
            emit(result)

        run.emit = emit_with_spans
        try:
            return run.main(argv)
        finally:
            run.emit = emit


if __name__ == "__main__":
    sys.exit(main())
