"""Running-average meters and device-synchronised timers (an own copy of
the JAX package's ``utils/meters.py``)."""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class AvgMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg, self.sum, self.cnt = 0.0, 0.0, 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / self.cnt


class Timer:
    """Accumulating named timer; ``sync=True`` waits for the CUDA device on
    both edges (when there is one), so the span is the device's wall time
    and not the time to enqueue its work."""

    timer_map: dict[str, float] = defaultdict(float)

    def __init__(self, name: str, sync: bool = False, print_time: bool = False):
        self.name = name
        self.sync = sync
        self.print_time = print_time

    def _barrier(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()

    def __enter__(self):
        self._barrier()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._barrier()
        Timer.timer_map[self.name] += time.perf_counter() - self.t0
        if self.print_time:
            print(self.name, round(Timer.timer_map[self.name], 4))
