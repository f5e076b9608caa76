"""Background-thread batch prefetching (counterpart of
``cmdgen_tpu/data/prefetch.py``): a bounded queue fed by one producer
thread, so the host builds the next batches (padding, tokenizing,
pharmacophore graphs) while the device runs the current step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

_SENTINEL = object()


def prefetch(iterator: Iterator, buffer_size: int = 4) -> Iterator:
    """Wrap a batch iterator with a background producer thread; an
    exception in the producer is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    error: list = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # handed to the consumer, raised there
            error.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item


class PrefetchedLoader:
    """A loader over several epochs: ``for batch in loader.epoch():``, each
    epoch a fresh ``make_iterator()`` behind :func:`prefetch`."""

    def __init__(self, make_iterator: Callable[[], Iterator], buffer_size: int = 4):
        self._make = make_iterator
        self._buffer = buffer_size

    def epoch(self) -> Iterator:
        return prefetch(self._make(), self._buffer)
