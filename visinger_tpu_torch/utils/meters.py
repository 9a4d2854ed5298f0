"""Running-average meters (an own copy of the JAX package's
``utils/meters.py``) and ``span``, the named ranges that frame the layers of
a training step and of a synthesis call in a ``torch.profiler`` trace."""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast


class AvgMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg, self.sum, self.cnt = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / self.cnt


_OFF = contextlib.nullcontext()


def span(name: str, unit=None, **args):
    """A context manager that records ``name`` as a range of the host thread
    in the running ``torch.profiler`` trace, on the clock of the trace's
    kernels and runtime calls; ``unit`` (the step, or the request group)
    and any keyword ``args`` (counts of the span's work) are kept as its
    arguments when the profiler records shapes.

    With no profiler running it is one shared no-op context: no allocation,
    no profiler call.  The range is an ordinary host operation and not a
    ``record_function`` user annotation, which the profiler also draws on
    the device's track as a CUDA event (read by a trace reader as device
    work); it adds no synchronisation and no device work."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if unit is not None:
        args = {"unit": unit, **args}
    if not args:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, (), args)
