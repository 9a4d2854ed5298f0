"""Background-thread batch prefetcher (an own copy of the JAX package's
``data/prefetch.py``): one producer thread builds the next batches (decode,
collate, pad, pin) while the device runs the current step."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    An exception of the producer re-raises in the consumer after the items
    before it.  If the consumer abandons the generator early (the trainer
    stops at ``max_updates`` mid-epoch), closing it sets ``stop`` and drains
    the queue, so the producer exits instead of blocking in ``q.put`` while
    holding up to depth + 1 batches.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            # the sentinel must reach the consumer or it blocks in q.get()
            put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # release any batches the producer already queued
            try:
                q.get_nowait()
            except queue.Empty:
                break
