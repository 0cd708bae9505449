"""A blocking queue with timeouts.

The ``Queue`` of ``faabric_tpu/util/queues.py``: a mutex and condition
variable around a deque. The RPC servers' work queues and the
executors' task queues are these.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Generic, TypeVar

T = TypeVar("T")


class QueueTimeoutException(Exception):
    pass


class Queue(Generic[T]):
    def __init__(self) -> None:
        self._items: collections.deque[T] = collections.deque()
        self._cond = threading.Condition(threading.Lock())

    def enqueue(self, item: T) -> None:
        with self._cond:
            self._items.append(item)
            self._cond.notify()

    def dequeue(self, timeout: float | None = None) -> T:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._items:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise QueueTimeoutException("Timeout waiting for dequeue")
                if not self._cond.wait(remaining):
                    raise QueueTimeoutException("Timeout waiting for dequeue")
            return self._items.popleft()

    def size(self) -> int:
        with self._cond:
            return len(self._items)
