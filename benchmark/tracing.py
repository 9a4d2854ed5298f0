"""Reading a ``torch.profiler`` trace of a stretch of the window: the device
kernels and their intervals, the device's busy time (the union of the
kernel intervals), the operations that took most device time, and the
longest idle gaps by the host operation that was running meanwhile; and
the count of synchronising calls under ``set_sync_debug_mode("warn")``."""

from __future__ import annotations

import heapq
import time
import warnings
from dataclasses import dataclass, field


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_us, end_us)
    host_ops: list = field(default_factory=list)  # (name, start_us, end_us)
    window_s: float = 0.0                         # host seconds traced
    units: int = 0                                # steps or calls traced

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, start, stop in sorted(self.kernels, key=lambda k: k[1]):
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy / 1e6

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of the kernels whose name matches ``pattern``
        (a compiled regular expression)."""
        return sum(stop - start for name, start, stop in self.kernels
                   if pattern.search(name)) / 1e6


    def device_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...] of the ``n`` kernels that took most device
        time."""
        by_name: dict[str, float] = {}
        for name, start, stop in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host operation, seconds], ...]: the device's idle time between
        kernels, summed by the innermost host operation running at each
        gap's middle, the ``n`` largest."""
        gaps, end = [], None
        for _, start, stop in sorted(self.kernels, key=lambda k: k[1]):
            if end is not None and start > end:
                gaps.append(((start + end) / 2, (start - end) / 1e6))
            end = stop if end is None else max(end, stop)
        gaps.sort()
        ops = sorted(self.host_ops, key=lambda o: o[1])
        heap: list = []
        at = 0
        by_name: dict[str, float] = {}
        for mid, seconds in gaps:
            while at < len(ops) and ops[at][1] <= mid:
                name, start, stop = ops[at]
                heapq.heappush(heap, (-start, stop, name))
                at += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "(Python between operations)"
            by_name[name] = by_name.get(name, 0.0) + seconds
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]


def profile(torch, fn, units: int, cuda: bool = True) -> Trace:
    """Run ``fn()`` (``units`` steps or calls) under the profiler, the
    device synchronised at both ends, and read the trace (without ``cuda``,
    of the host alone: the CPU tests)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    def sync():
        if cuda:
            torch.cuda.synchronize()

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync()
    with _profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    trace = Trace(window_s=window, units=units)
    on_device = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        start, stop = e.time_range.start, e.time_range.end
        if e.device_type == on_device:
            trace.kernels.append((e.name, start, stop))
        else:
            trace.host_ops.append((e.name, start, stop))
    return trace


def sync_count(torch, fn, cuda: bool = True) -> int:
    """The synchronising calls ``fn()`` makes, counted as the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` (0 without ``cuda``)."""
    if not cuda:
        fn()
        return 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(1 for w in caught if "synchroniz" in str(w.message))
